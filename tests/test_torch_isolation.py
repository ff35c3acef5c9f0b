"""The port runs without JAX and without the JAX package: a fresh process
imports ``repro_torch``, builds and matches on the CPU through both joins,
also with the int8 sidecar, dr plans and the stacked probe, with a grouped
index (auto group sizes) and the stacked probe's hand-off to the device
join, under live updates with compaction and the result cache, through a
2-host ``ClusterEngine`` and through the scalar match, takes a snapshot,
replays a WAL and scrubs the recovered engine, runs the dense scan, the DCN-v2 serve and retrieval steps and the
gemma3-1b prefill and decode steps through ``repro_torch.configs`` and a
short ``DecodeEngine`` run, the prefill and decode steps of the other four
LMs, the MoE block, both modes of the serving launcher, one train step of
DCN-v2, gemma3-1b and deepseek-v2-lite, a compressed
``Trainer`` run and its checkpoint read back through ``convert``, and no
``jax*`` or ``repro`` module is loaded."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"

SCRIPT = """
import sys
from repro_torch.core import GnnPeConfig, GnnPeEngine, vf2_match
from repro_torch.graphs import newman_watts_strogatz, random_connected_query

g = newman_watts_strogatz(150, k=4, p=0.15, n_labels=5, seed=1)
eng = GnnPeEngine(GnnPeConfig(encoder="monotone", n_partitions=2), device="cpu").build(g)
qs = [random_connected_query(g, 5, seed=s) for s in range(3)]
for q, m, d in zip(qs, eng.match_many(qs), eng.match_many(qs, join_impl="device")):
    assert set(m) == set(vf2_match(g, q)) == set(d)
cfg = GnnPeConfig(encoder="monotone", n_partitions=2, quantize_index=True, plan_weight="dr",
                  probe_impl="stacked")
eng_q = GnnPeEngine(cfg, device="cpu").build(g)
assert eng_q.offline_stats["stacked_bytes"] > 0
for q, m, d in zip(qs, eng_q.match_many(qs), eng_q.match_many(qs, join_impl="device")):
    assert set(m) == set(vf2_match(g, q)) == set(d)
    assert eng_q.match(q, impl="scalar") == m
cfg = GnnPeConfig(encoder="monotone", n_partitions=3, index_kind="grouped",
                  group_size_mode="auto", probe_impl="stacked", join_impl="device",
                  plan_weight="dr")
eng_g = GnnPeEngine(cfg, device="cpu").build(g)
assert eng_g.offline_stats["n_groups"] > 0 and len(eng_g.offline_stats["group_sizes"]) == 3
before = eng_g.stacked_probe().host_expansions
for q, m, l in zip(qs, eng_g.match_many(qs), eng_g.match_many(qs, probe_impl="loop", join_impl="numpy")):
    assert set(m) == set(vf2_match(g, q)) == set(l)
assert eng_g.stacked_probe().host_expansions == before
import numpy as np
from repro_torch.core import GraphUpdate
cfg = GnnPeConfig(encoder="monotone", n_partitions=2, probe_impl="stacked", cache=True,
                  delta_compact_min=4, delta_compact_frac=0.01)
eng_u = GnnPeEngine(cfg, device="cpu").build(g)
e = g.edge_array()
for k in range(2):
    upd = GraphUpdate(remove_edges=e[k : k + 2], add_edges=np.array([[0, 77 + k]]))
    s = eng_u.apply_updates(upd)
    assert s["mutated"] and s["compacted"]
    for q, m, d in zip(qs, eng_u.match_many(qs), eng_u.match_many(qs, join_impl="device")):
        assert set(m) == set(vf2_match(eng_u.graph, q)) == set(d)
assert eng_u.match_many(qs) and eng_u.delta_stats()["cache"]["hits"] > 0
from repro_torch.dist import ClusterEngine
cl = ClusterEngine(eng_u, n_hosts=2, cache_capacity=8)
assert cl.match_many(qs) == eng_u.match_many(qs) and all(h.owned for h in cl.hosts)
import tempfile
from repro_torch.durability import DurabilityConfig, engine_fingerprint, recover_engine, scrub_engine
from repro_torch.serve import MatchServeConfig, MatchServer
with tempfile.TemporaryDirectory() as d:
    eng_d = GnnPeEngine(GnnPeConfig(encoder="monotone", n_partitions=2), device="cpu").build(g)
    srv = MatchServer(eng_d, MatchServeConfig(durability=DurabilityConfig(d, snapshot_every=0)))
    srv.submit_update(GraphUpdate(remove_edges=e[5:7], add_edges=np.array([[1, 90]])))
    srv.apply_update_tick()
    rec, info = recover_engine(DurabilityConfig(d), device="cpu")
    assert info["snapshot_epoch"] == 0 and info["replayed"] == 1
    assert engine_fingerprint(rec) == engine_fingerprint(eng_d)
    assert rec.match_many(qs) == eng_d.match_many(qs) and scrub_engine(rec)["ok"]
import torch
from repro_torch.kernels.dominance_scan import ops
idx = eng.models[0].index
assert ops.dominance_scan(idx.emb[:3].contiguous(), idx.emb0[:3].contiguous(), idx.emb, idx.emb0).shape == (3, idx.n_paths)
assert ops.dominance_scan(idx.emb[0].contiguous(), idx.emb0[0].contiguous(), idx.emb, idx.emb0)[0]
from repro_torch.configs import build_step, get_arch, init_params, make_batch, resolve_config
arch = get_arch("dcn-v2")
for name in ("serve_p99", "retrieval_cand"):
    cell = arch.cell(name)
    cfg = resolve_config(arch, cell, smoke=True)
    params = init_params(arch, cfg, seed=0, device="cpu")
    out = build_step(arch, cell, cfg)[0](params, make_batch(arch, cell, cfg, device="cpu"))
    logits = out if name == "serve_p99" else out[0]
    assert logits.shape[0] == (8 if name == "serve_p99" else 1) and torch.isfinite(logits).all()
arch = get_arch("gemma3-1b")
for name in ("prefill_32k", "decode_32k"):
    cell = arch.cell(name)
    cfg = resolve_config(arch, cell, smoke=True)
    params = init_params(arch, cfg, seed=0, device="cpu")
    out = build_step(arch, cell, cfg)[0](params, make_batch(arch, cell, cfg, device="cpu"))
    logits = out if name == "prefill_32k" else out[0]
    assert logits.shape[-1] == cfg.vocab and torch.isfinite(logits).all()
from repro_torch.serve import DecodeEngine, ServeConfig
eng = DecodeEngine(params, cfg, ServeConfig(max_batch=2, max_len=16, eos_token=-1), device="cpu")
for p in ([1, 2], [3], [4, 5, 6]):
    eng.submit(p, max_new=3)
assert sorted(eng.run_until_drained()) == [0, 1, 2]
for an in ("minitron-4b", "command-r-plus-104b", "deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"):
    a = get_arch(an)
    cfg = resolve_config(a, a.cell("decode_32k"), smoke=True)
    params = init_params(a, cfg, seed=0, device="cpu")
    for cn in ("prefill_32k", "decode_32k"):
        cell = a.cell(cn)
        out = build_step(a, cell, cfg)[0](params, make_batch(a, cell, cfg, device="cpu"))
        logits = out if cn == "prefill_32k" else out[0]
        assert logits.shape[-1] == cfg.vocab and torch.isfinite(logits).all()
from repro_torch.models import MoEConfig, moe_block, init_moe_params
mp = init_moe_params(torch.Generator().manual_seed(0), 16, MoEConfig(n_experts=4, top_k=2,
                                                                     d_ff_expert=8, n_shared=1))
assert moe_block(torch.randn(6, 16), mp, MoEConfig(n_experts=4, top_k=2, d_ff_expert=8,
                                                     n_shared=1))[0].shape == (6, 16)
from repro_torch.launch.serve import main as serve_main
assert len(serve_main(["--mode", "lm", "--arch", "deepseek-v2-lite-16b", "--requests", "3",
                       "--device", "cpu"])["finished"]) == 3
assert serve_main(["--mode", "gnnpe", "--n", "1000", "--requests", "3", "--device", "cpu"])[
    "queries"] == 3
from repro_torch.configs import opt_init
for an, cn in (("dcn-v2", "train_batch"), ("gemma3-1b", "train_4k"),
               ("deepseek-v2-lite-16b", "train_4k")):
    a = get_arch(an)
    cell = a.cell(cn)
    cfg = resolve_config(a, cell, smoke=True)
    params = init_params(a, cfg, seed=0, device="cpu", train=True)
    step, takes_opt = build_step(a, cell, cfg)
    new, opt, met = step(params, opt_init(params), make_batch(a, cell, cfg, device="cpu"))
    assert takes_opt and int(opt["step"]) == 1 and torch.isfinite(met["loss"])
from repro_torch.data import LMSyntheticData
from repro_torch.train import CompressionConfig, OptConfig, Trainer, TrainerConfig
from repro_torch.models import TransformerConfig, init_lm_params, lm_loss
from repro_torch.convert import trainer_state_from_reference
tcfg = TransformerConfig(n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64,
                         vocab=64, attention="local_global", global_period=6,
                         tie_embeddings=True, dtype="float32", kv_chunk=16, remat=False)
data = LMSyntheticData(vocab=64, batch=2, seq_len=16, seed=0)
with tempfile.TemporaryDirectory() as d:
    tr = Trainer(lambda p, b: lm_loss(p, b, tcfg), init_lm_params(torch.Generator().manual_seed(0), tcfg),
                 data.batch_at, TrainerConfig(total_steps=4, ckpt_every=2, ckpt_dir=d,
                 opt=OptConfig(lr=1e-3, warmup_steps=0, total_steps=4),
                 compression=CompressionConfig(kind="topk", topk_frac=0.1)))
    out = tr.run()
    assert out["final_step"] == 4 and int(trainer_state_from_reference(d, device="cpu")["step"]) == 4
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] == "repro" or m.split(".")[0].startswith("jax")
)
assert not bad, bad
print("ok")
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT], env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
