"""The LM architectures, the JAX package's ``configs/lm_archs.py``: each one's
published config and its smoke variant, under the same sources.

long_500k runs for gemma3-1b (5:1 sliding-window hybrid) and
deepseek-v2-lite (MLA's compressed cache); the three pure full-attention
archs skip it with the reference's reason.
"""
from __future__ import annotations

from ..models import MoEConfig, TransformerConfig
from .base import ArchDef, lm_cells

_SKIP_FULL_ATTN = "pure full-attention arch: no sub-quadratic mechanism for 0.5M-token decode"


def _minitron(smoke: bool) -> TransformerConfig:
    if smoke:
        return TransformerConfig(
            name="minitron-4b", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=192, vocab=512, dtype="float32", kv_chunk=32, remat=False,
        )
    return TransformerConfig(
        name="minitron-4b",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        head_dim=128,
        d_ff=9216,
        vocab=256000,
        dtype="bfloat16",
        kv_chunk=1024,
        grad_accum=4,
        remat_attention=True,
    )


def _gemma3(smoke: bool) -> TransformerConfig:
    if smoke:
        return TransformerConfig(
            name="gemma3-1b", n_layers=6, d_model=64, n_heads=4, n_kv_heads=1,
            head_dim=16, d_ff=192, vocab=512, attention="local_global", window=16,
            global_period=6, tie_embeddings=True, dtype="float32", kv_chunk=32, remat=False,
        )
    return TransformerConfig(
        name="gemma3-1b",
        n_layers=26,
        d_model=1152,
        n_heads=4,
        n_kv_heads=1,
        head_dim=256,
        d_ff=6912,
        vocab=262144,
        attention="local_global",
        window=512,  # gemma-3-1b sliding window
        global_period=6,  # 5 local : 1 global
        tie_embeddings=True,
        dtype="bfloat16",
        kv_chunk=1024,
        grad_accum=2,
        remat_attention=True,
    )


def _command_r(smoke: bool) -> TransformerConfig:
    if smoke:
        return TransformerConfig(
            name="command-r-plus-104b", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
            head_dim=8, d_ff=192, vocab=512, dtype="float32", kv_chunk=32, remat=False,
        )
    return TransformerConfig(
        name="command-r-plus-104b",
        n_layers=64,
        d_model=12288,
        n_heads=96,
        n_kv_heads=8,
        head_dim=128,
        d_ff=33792,
        vocab=256000,
        dtype="bfloat16",
        param_dtype="bfloat16",
        kv_chunk=1024,
        grad_accum=16,
        remat_attention=True,
    )


def _deepseek(smoke: bool) -> TransformerConfig:
    if smoke:
        return TransformerConfig(
            name="deepseek-v2-lite-16b", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
            use_mla=True, kv_lora_rank=32, rope_head_dim=8, nope_head_dim=16, v_head_dim=16,
            d_ff=192, vocab=512, first_dense=1,
            moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=48, n_shared=2),
            dtype="float32", kv_chunk=32, remat=False,
        )
    return TransformerConfig(
        name="deepseek-v2-lite-16b",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        use_mla=True,
        kv_lora_rank=512,
        rope_head_dim=64,
        nope_head_dim=128,
        v_head_dim=128,
        d_ff=10944,  # the dense first layer
        first_dense=1,
        moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2),
        vocab=102400,
        dtype="bfloat16",
        param_dtype="bfloat16",
        kv_chunk=1024,
        grad_accum=4,
        remat_attention=True,
    )


def _qwen3(smoke: bool) -> TransformerConfig:
    if smoke:
        return TransformerConfig(
            name="qwen3-moe-235b-a22b", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=192, vocab=512,
            moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=48),
            dtype="float32", kv_chunk=32, remat=False,
        )
    return TransformerConfig(
        name="qwen3-moe-235b-a22b",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        head_dim=128,
        d_ff=1536,
        vocab=151936,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536, fsdp=True),
        dtype="bfloat16",
        param_dtype="bfloat16",
        kv_chunk=1024,
        grad_accum=8,
        remat_attention=True,
    )


MINITRON = ArchDef(
    "minitron-4b", "lm", _minitron, lm_cells(skip_long=_SKIP_FULL_ATTN),
    source="arXiv:2407.14679",
)
GEMMA3 = ArchDef(
    "gemma3-1b", "lm", _gemma3, lm_cells(skip_long=None), source="hf:google/gemma-3-1b-pt",
)
COMMAND_R = ArchDef(
    "command-r-plus-104b", "lm", _command_r, lm_cells(skip_long=_SKIP_FULL_ATTN),
    source="hf:CohereForAI/c4ai-command-r-v01",
)
# MLA (kv_lora 512, absorbed decode); 64 routed experts top-6 + 2 shared, as the official
# V2-Lite (the reference's note: its assignment lists both 64 and 160 routed experts)
DEEPSEEK = ArchDef(
    "deepseek-v2-lite-16b", "lm", _deepseek, lm_cells(skip_long=None), source="arXiv:2405.04434",
)
QWEN3 = ArchDef(
    "qwen3-moe-235b-a22b", "lm", _qwen3, lm_cells(skip_long=_SKIP_FULL_ATTN),
    source="hf:Qwen/Qwen3-235B-A22B",
)
