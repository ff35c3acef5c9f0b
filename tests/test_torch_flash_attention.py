"""K6's plain path in the port against the JAX package, on the CPU.

The JAX Pallas kernel does not run on the installed JAX (it calls
``pl.load``), so the port is held against the JAX package's plain paths:
``flash_attention(..., use_pallas=False)`` (the S × S oracle over repeated
heads) and the model's ``chunked_attention``.  Inputs are seeded NumPy
normals.  Tolerances: float32 within 1e-5 (the same float32 algorithm,
summed in another order); bf16 within 1e-2 absolute and relative (both
sides compute in float32 and round the output to bf16 once, so they may
differ by a bf16 ulp, 2⁻⁸ relative).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref  # noqa: E402
from repro.models.transformer import chunked_attention as jax_chunked  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    chunked_attention,
    flash_attention_ref,
    make_attn,
)

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1e-2, atol=1e-2)


def _as(dtype, *arrays):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _jax(dtype, *arrays):
    return [jnp.asarray(a, dtype) for a in arrays]


@pytest.mark.parametrize("dh", [16, 64])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 5), (False, None), (False, 9)])
def test_flash_attention_matches_jax_plain_path(causal, window, G, dh):
    """S = 37 is a multiple of no block, and the plain chunk of 16 pads the last chunk."""
    q, k, v = make_attn(2, 37, 2 * G, 2, dh, seed=G * dh + (window or 0))
    want = jax_flash_attention(*_jax(jnp.float32, q, k, v), causal=causal, window=window,
                               use_pallas=False)
    before = ops.LAUNCHES
    got = ops.flash_attention(*_as(torch.float32, q, k, v), causal=causal, window=window,
                              chunk=16)
    assert ops.LAUNCHES == before  # the CPU takes the plain version
    assert got.shape == (2, 37, 2 * G, dh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("G,window", [(1, None), (4, 7), (4, None)])
def test_flash_attention_bf16_matches_jax_plain_path(G, window):
    q, k, v = make_attn(1, 50, G, 1, 32, seed=G)
    want = jax_flash_attention(*_jax(jnp.bfloat16, q, k, v), window=window, use_pallas=False)
    got = ops.flash_attention(*_as(torch.bfloat16, q, k, v), window=window, chunk=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **BF16)


@pytest.mark.parametrize("Sq,chunk,window", [(40, 16, None), (40, 16, 7), (32, 32, None),
                                             (33, 8, 16), (5, 64, 3)])
def test_chunked_attention_matches_jax(Sq, chunk, window):
    """The model's scan, padded last chunk included, with and without the
    per-layer window, on the grouped (B, Sq, Hkv, G, dh) layout."""
    rng = np.random.default_rng(Sq + chunk)
    q = rng.normal(size=(2, Sq, 2, 3, 16)).astype(np.float32)
    k = rng.normal(size=(2, Sq, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, Sq, 2, 16)).astype(np.float32)
    pos = np.arange(Sq, dtype=np.int32)
    want = jax_chunked(*_jax(jnp.float32, q, k, v), jnp.asarray(pos), jnp.asarray(pos),
                       window, chunk)
    got = chunked_attention(*_as(torch.float32, q, k, v), torch.from_numpy(pos),
                            torch.from_numpy(pos), window, chunk)
    assert got.shape == (2, Sq, 6, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 4), (False, 6)])
def test_flash_attention_ref_matches_jax(causal, window):
    q, k, v = (a[:, :, 0] for a in make_attn(3, 21, 1, 1, 16, seed=11))
    want = jax_ref(*_jax(jnp.float32, q, k, v), causal, window)
    got = flash_attention_ref(*_as(torch.float32, q, k, v), causal, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _flat_heads(t, G: int):
    """(B, S, H, dh) → (B·H·G, S, dh), each head repeated G times."""
    return t.repeat_interleave(G, 2).transpose(1, 2).reshape(-1, t.shape[1], t.shape[3])


def test_plain_path_agrees_with_the_oracle_at_any_chunk():
    q, k, v = _as(torch.float32, *make_attn(1, 45, 4, 2, 16, seed=3))
    want = flash_attention_ref(_flat_heads(q, 1), _flat_heads(k, 2), _flat_heads(v, 2), True, 10)
    for chunk in (1, 7, 45, 1024):
        got = ops.flash_attention(q, k, v, window=10, chunk=chunk)
        np.testing.assert_allclose(_flat_heads(got, 1).numpy(), want.numpy(), **F32)


def test_wrapper_raises_on_what_it_does_not_take():
    q, k, v = _as(torch.float32, *make_attn(1, 8, 4, 2, 16, seed=0))
    with pytest.raises(TypeError, match="plain version"):
        ops.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError, match="one dtype"):
        ops.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="shapes"):
        ops.flash_attention(q[0], k, v)
    with pytest.raises(ValueError, match="shapes"):
        ops.flash_attention(q[:, :, :3], k, v)  # 3 query heads over 2 KV heads
    with pytest.raises(ValueError, match="shapes"):
        ops.flash_attention(q, k, v[:, :7])
    with pytest.raises(ValueError, match="shapes"):
        ops.flash_attention(q[..., :8], k, v)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="different devices"):
        ops.flash_attention(q, k.to("meta"), v)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def _k6_numerics(q, k, v, causal, window):
    """K6's arithmetic on the CPU: float32 scores times dh^-1/2 · log2(e), max and
    sum over KV tiles of 64 keys (dh > 128) or 128, exp2, P rounded to bf16 for P·V,
    the output rounded to bf16 once."""
    B, S, Hq, dh = q.shape
    G = Hq // k.shape[2]
    tile = 64 if dh > 128 else 128
    scale_log2 = torch.tensor(dh**-0.5) * torch.tensor(1.4426950408889634)  # float32, as K6
    qf = q.float().transpose(1, 2)
    kf, vf = (t.float().repeat_interleave(G, 2).transpose(1, 2) for t in (k, v))
    pos = torch.arange(S)
    m = torch.full((B, Hq, S), -1e30)
    l, acc = torch.zeros((B, Hq, S)), torch.zeros((B, Hq, S, dh))
    for lo in range(0, S, tile):
        pc = pos[lo:lo + tile]
        allowed = pc[None] <= (pos[:, None] if causal else S)
        if window is not None:
            allowed &= (pos[:, None] - pc[None]) < window
        s = torch.where(allowed, qf @ kf[:, :, lo:lo + tile].transpose(-1, -2) * scale_log2,
                        -1e30)
        mx = torch.maximum(m, s.amax(-1))
        p = torch.where(allowed, torch.exp2(s - mx[..., None]), 0.0)
        alpha = torch.exp2(m - mx)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.bfloat16().float() @ vf[:, :, lo:lo + tile]
        m = mx
    return (acc / l.clamp_min(1e-30)[..., None]).bfloat16().transpose(1, 2)


def _agreement_case(fault: str, dh: int) -> None:
    from repro_torch.kernels.flash_attention.ref import (
        attention_scale,
        flash_attention_plain,
        k6_agreement,
    )

    q, k, v = _as(torch.bfloat16, *make_attn(1, 1000, 4, 1, dh, seed=3))
    causal, window = (False, None) if fault == "padded_keys" else (True, 100)
    want = flash_attention_plain(q, k, v, causal, window)
    scale = attention_scale(q, k, v, causal, window)
    got = _k6_numerics(q, k, v, causal, window)
    if fault == "padded_keys":
        pad = [torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 24)) for t in (q, k, v)]
        got = flash_attention_plain(*pad, causal=False)[:, :1000]
    elif fault == "window_plus_one":
        got = flash_attention_plain(q, k, v, causal, window + 1)
    elif fault == "dropped_tile":  # keys 64-127 never seen
        pos = torch.arange(1000, dtype=torch.int32)
        kv_pos = torch.where((pos >= 64) & (pos < 128), 2**30, pos)
        got = chunked_attention(q.reshape(1, 1000, 1, 4, dh), k, v, pos, kv_pos, window, 1024
                                ).reshape(q.shape)
    res = k6_agreement(got, want, scale)
    assert res["ok"] == (fault == "none"), res


FAULTS = ["none", "padded_keys", "window_plus_one", "dropped_tile"]


@pytest.mark.parametrize("fault", FAULTS)
def test_k6_agreement_admits_the_kernels_rounding_and_rejects_planted_faults(fault):
    """The tolerance chip_smoke.py holds K6 to: K6's own rounding passes, and a
    plain version with a planted fault fails it.  The padded-keys fault is
    the first plain version's (the zero-padded keys of the last chunk
    counted as keys): 24 of 1,024 keys, 2.4 % of a non-causal row."""
    _agreement_case(fault, dh=64)


@pytest.mark.parametrize("fault", FAULTS)
def test_k6_agreement_at_gemma3_head_width(fault):
    """The same at dh = 256, where K6 walks KV tiles of 64 keys."""
    _agreement_case(fault, dh=256)
