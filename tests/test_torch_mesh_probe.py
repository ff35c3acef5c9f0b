"""The in-process meshes on the CPU: the stacked probe over a ``part``
device list and the device join over a ``join`` device list, each list
naming the CPU 2 or 3 times.

``build_stacked(n_shards=n)`` equals the JAX package's field by field for
n = 1, 2, 3 (filler slots and all).  ``StackedProbe(devices=["cpu"] * n)``
descends each shard's run of slots on its own and gives ``probe``'s lists
of one device in order and ``probe_device``'s candidates as sets per
(query, plan path), with both index kinds.  At engine level, the host-join
lists over n devices equal the reference engine's with its probe over n
host devices (one subprocess with 3), with both index kinds.  The device
join over 2 and 3 devices, on 3 queries (each a group of one, padded with
phantoms) and on 3 isomorphic ones (one group of 3), gives the one-device
device join's lists and VF2's sets, each step run once a shard; it is not
held to the reference's own join over several devices, which fails on the
installed JAX (ROADMAP §3)."""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import stacked as RS  # noqa: E402
from repro_torch.core import GnnPeConfig, GnnPeEngine, vf2_match  # noqa: E402
from repro_torch.core import matcher as PM  # noqa: E402
from repro_torch.core import stacked as PS  # noqa: E402
from repro_torch.dist import StackedProbe  # noqa: E402
from repro_torch.dist import probe as probe_mod  # noqa: E402
from repro_torch.dist.context import use_devices  # noqa: E402
from repro_torch.graphs import from_edge_list, newman_watts_strogatz, random_connected_query  # noqa: E402
from test_torch_grouped import _t, indexes, queries  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
GROUPS = (16, 8, 32)
KINDS = {"path": {}, "grouped": dict(index_kind="grouped", group_size=8)}
BASE = dict(n_partitions=5, encoder="monotone", block_size=32, probe_impl="stacked")


def _equal_stacked(got, want) -> None:
    np.testing.assert_array_equal(got.slot_of, want.slot_of)
    assert (got.n_shards, got.n_slots, got.n_levels) == (want.n_shards, want.n_slots,
                                                         want.n_levels)
    np.testing.assert_array_equal(got.n_paths.numpy(), want.n_paths)
    for name in ("level_hi", "level_lo0", "level_hi0"):
        for a, b in zip(getattr(got, name), getattr(want, name)):
            np.testing.assert_array_equal(a.numpy(), b)
    for name in ("emb_cat", "emb0", "emb_q", "label_hash"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), b)
    assert (got.groups is None) == (want.groups is None)
    if got.groups is not None:
        for name in ("hi", "lo0", "hi0", "start", "count"):
            np.testing.assert_array_equal(getattr(got.groups, name).numpy(),
                                          getattr(want.groups, name))
        assert got.groups.gpb == want.groups.gpb
    assert got.padding_stats() == want.padding_stats()


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_build_stacked_over_n_shards_equals_the_reference(n, grouped):
    ref, port, _, _ = indexes(11, True, 1, group_sizes=GROUPS if grouped else None)
    want = RS.build_stacked(ref, n_shards=n)
    got = PS.build_stacked(port, n_shards=n)
    _equal_stacked(got, want)
    if n == 3:  # 700 | 300 | 20, 1, 0 paths: 3 shards of 3 slots, 4 of them fillers
        assert got.n_slots == 9 and got.slot_of.tolist() == [0, 6, 7, 8, 3]


def test_a_given_layout_survives_another_shard_count():
    _, port, _, _ = indexes(12, False, 0)
    donor = PS.build_stacked(port, n_shards=3)
    again = PS.build_stacked(port, n_shards=2, slot_of=donor.slot_of)
    np.testing.assert_array_equal(again.slot_of, donor.slot_of)
    assert donor.n_slots == 9 and again.n_slots == 10 and again.n_shards == 2
    with pytest.raises(ValueError, match="distinct"):
        PS.build_stacked(port, slot_of=[0, 0, 1, 2, 3])


@pytest.mark.parametrize("use_groups", [False, True])
@pytest.mark.parametrize("n", [2, 3])
def test_probe_over_a_part_list_equals_one_device(n, use_groups, monkeypatch):
    ref, port, vocab, rng = indexes(13, True, 2, group_sizes=GROUPS if use_groups else None)
    q_emb, q_emb0, q_multi, qh = queries(ref, vocab, rng, 6, 2)
    args = (_t(q_emb), _t(q_emb0), _t(q_multi), _t(qh))
    one = StackedProbe(port, devices=["cpu"])
    many = StackedProbe(port, devices=["cpu"] * n)
    assert many.stacked.n_shards == n and len(many._shards) == n
    runs = []
    descend = probe_mod.StackedProbe._descend
    monkeypatch.setattr(probe_mod.StackedProbe, "_descend",
                        lambda self, *a: runs.append(a[2].shape[0]) or descend(self, *a))
    want, want_stats = one.probe(*args, use_groups=use_groups, return_stats=True)
    runs.clear()
    got, got_stats = many.probe(*args, use_groups=use_groups, return_stats=True)
    assert runs == [many.stacked.n_slots // n] * n  # each shard's run of slots
    assert got_stats == want_stats
    hits = 0
    for per_want, per_got in zip(want, got):
        for w, g in zip(per_want, per_got):
            assert torch.equal(w, g)
            hits += int(w.numel())
    assert hits > 0
    wd, wc = one.probe_device(*args, use_groups=use_groups)
    gd, gc = many.probe_device(*args, use_groups=use_groups)
    np.testing.assert_array_equal(gc, wc)
    for a, b in zip(wd, gd):
        assert {tuple(r) for r in a.tolist()} == {tuple(r) for r in b.tolist()}
    assert sum(int(a.shape[0]) for a in gd) > 0


REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=3"
import pickle, sys
import jax
from repro.core import GnnPeConfig, GnnPeEngine
from repro.dist.probe import StackedProbe
from repro.graphs import newman_watts_strogatz, random_connected_query
from repro_torch.convert import partition_state_from_reference

base, kinds = pickle.loads(bytes.fromhex(sys.argv[1]))
g = newman_watts_strogatz(400, k=4, p=0.15, n_labels=6, seed=3)
qs = [random_connected_query(g, 4 + s % 3, seed=70 + s) for s in range(6)]
out = {}
for kind, extra in kinds.items():
    eng = GnnPeEngine(GnnPeConfig(**base, **extra)).build(g)
    lists = {}
    for n in (1, 2, 3):
        eng._stacked_probe = StackedProbe([m.index for m in eng.models],
                                          devices=jax.devices()[:n],
                                          leaf_pair_cap=eng.cfg.stacked_leaf_pair_cap)
        assert eng._stacked_probe.stacked.n_shards == n
        lists[n] = eng.match_many(qs)
    out[kind] = {"params": partition_state_from_reference(eng.models), "lists": lists}
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh") / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    arg = pickle.dumps((BASE, KINDS)).hex()
    out = subprocess.run([sys.executable, "-c", REFERENCE, arg, str(path)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert "REF_OK" in out.stdout, out.stdout + out.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _graph_and_queries():
    g = newman_watts_strogatz(400, k=4, p=0.15, n_labels=6, seed=3)
    return g, [random_connected_query(g, 4 + s % 3, seed=70 + s) for s in range(6)]


@pytest.mark.parametrize("kind", list(KINDS))
def test_engine_probe_over_n_devices_equals_the_reference_engine(reference, kind):
    g, qs = _graph_and_queries()
    eng = GnnPeEngine(GnnPeConfig(**BASE, **KINDS[kind]), device="cpu").build(
        g, params=reference[kind]["params"])
    one = eng.match_many(qs)
    assert one == reference[kind]["lists"][1] and sum(map(len, one)) > 0
    for n in (2, 3):
        with use_devices("part", ["cpu"] * n):
            got = eng.match_many(qs)
            assert eng.stacked_probe().stacked.n_shards == n
            handoff = eng.match_many(qs, join_impl="device")
        assert got == reference[kind]["lists"][n] == one
        for q, m, h in zip(qs, got, handoff):
            assert set(m) == set(h) == set(vf2_match(g, q))
    assert eng.stacked_probe().stacked.n_shards == 1  # placed back on one device


def _isomorphic(q, n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = [q]
    e = q.edge_array()
    for _ in range(n - 1):
        perm = rng.permutation(q.n_vertices)
        labs = np.empty(q.n_vertices, np.int64)
        labs[perm] = q.labels
        out.append(from_edge_list(q.n_vertices, np.stack([perm[e[:, 0]], perm[e[:, 1]]], 1),
                                  labs))
    return out


@pytest.mark.parametrize("probe_impl", ["loop", "stacked"])
def test_device_join_over_a_join_list_equals_one_device(reference, probe_impl, monkeypatch):
    g, qs = _graph_and_queries()
    eng = GnnPeEngine(GnnPeConfig(**BASE), device="cpu").build(
        g, params=reference["path"]["params"])
    calls = []
    init = PM._init_body
    monkeypatch.setattr(PM, "_init_body", lambda c, *a, **k: calls.append(c.shape[0])
                        or init(c, *a, **k))
    for batch in (qs[:3], _isomorphic(qs[1], 3, seed=5)):
        calls.clear()
        want = eng.match_many(batch, join_impl="device", probe_impl=probe_impl)
        one = list(calls)
        assert sum(map(len, want)) > 0
        for q, m in zip(batch, want):
            assert set(m) == set(vf2_match(g, q))
        for n in (2, 3):
            calls.clear()
            with use_devices("join", ["cpu"] * n):
                got = eng.match_many(batch, join_impl="device", probe_impl=probe_impl)
            assert got == want, n
            # every group's first step ran once a shard, on blocks of ⌈B / n⌉ members
            assert len(calls) == n * len(one)
            assert sorted(calls) == sorted(-(-b // n) for b in one for _ in range(n))
