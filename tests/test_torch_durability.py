"""The port's durability (``repro_torch.durability``) on the CPU, held against
the JAX package's (``repro.durability``) on its own fixtures: the 150-vertex
Erdős–Rényi graph (4 labels) in 3 partitions, monotone, ``n_multi=1``, and
its two configs; the port's engines carry the reference's weights
(``convert.partition_state_from_reference``).

- WAL: records and whole segments of one update stream are byte-equal
  between the packages, each opens the other's directory; torn tails,
  mid-stream and sealed-segment corruption, rotate and prune as the
  reference checks them;
- snapshots: ``engine_state`` has the reference's keys, dtypes, shapes and
  meta (float arrays within 1e-6, the tolerance of ``test_torch_engine``);
  a snapshot of either package restores in the other with the reference's
  match lists, order included; byte identity survives a round trip and one
  more epoch; a flipped byte falls back to the older step;
- the crash sweep: 2 configs × 5 kill points, each recovered port engine's
  fingerprint equal to the port control's and its lists to the reference's
  recovered engine's; a torn write, a corrupt WAL, no snapshot, a WAL gap;
  a compaction and ``update_slot`` before the crash under the grouped
  stacked probe;
- a directory written by the reference's ``MatchServer`` recovers in the
  port; the serving hooks (standing re-registration once, unsubscribe,
  genesis, ``MatchService``, ``ClusterEngine``); scrub and its CLI;
  ``examples/serve_queries_torch.py --wal`` killed and resumed.
"""
import asyncio
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.durability as RD  # noqa: E402
from repro.core import GnnPeConfig as RefConfig  # noqa: E402
from repro.core import GnnPeEngine as RefEngine  # noqa: E402
from repro.core import GraphUpdate as RefUpdate  # noqa: E402
from repro.durability import wal as ref_wal  # noqa: E402
from repro.graphs import erdos_renyi, random_connected_query  # noqa: E402
from repro.serve import match_server as ref_ms  # noqa: E402
from repro_torch import durability as PD  # noqa: E402
from repro_torch.convert import partition_state_from_reference  # noqa: E402
from repro_torch.core import GnnPeConfig, GnnPeEngine, GraphUpdate  # noqa: E402
from repro_torch.device import is_device_fault  # noqa: E402
from repro_torch.dist import ClusterEngine  # noqa: E402
from repro_torch.dist.checkpoint import CorruptCheckpointError  # noqa: E402
from repro_torch.durability import wal as port_wal  # noqa: E402
from repro_torch.durability.snapshot import _META_KEY, _SLOT_KEY  # noqa: E402
from repro_torch.graphs import Graph  # noqa: E402
from repro_torch.serve import MatchServeConfig, MatchServer, MatchService, ServiceConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

CONFIGS = {
    "path-loop": dict(index_kind="path", probe_impl="loop"),
    "grouped-stacked": dict(index_kind="grouped", probe_impl="stacked"),
}
BASE = dict(n_partitions=3, encoder="monotone", n_multi=1, block_size=32, group_size=4)

# the two packages behind one surface, so a scenario runs in either
REF = types.SimpleNamespace(
    name="reference", D=RD, Server=ref_ms.MatchServer, ServeConfig=ref_ms.MatchServeConfig,
    restore=lambda arrays: RD.restore_engine(arrays)[0],
    recover=lambda cfg: RD.recover_engine(cfg),
)
PORT = types.SimpleNamespace(
    name="port", D=PD, Server=MatchServer, ServeConfig=MatchServeConfig,
    restore=lambda arrays: PD.restore_engine(arrays, device="cpu")[0],
    recover=lambda cfg: PD.recover_engine(cfg, device="cpu"),
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: test files run in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graph():
    return erdos_renyi(150, avg_degree=3.5, n_labels=4, seed=5)


def port_graph(g) -> Graph:
    return Graph(g.offsets, g.nbrs, g.labels)


@pytest.fixture(scope="module")
def base(graph):
    """One build per config and package, kept as in-memory snapshots so every
    test clones byte-identical replicas instead of building again."""
    out = {}
    for name, kw in CONFIGS.items():
        ref = RefEngine(RefConfig(**BASE, **kw)).build(graph)
        port = GnnPeEngine(GnnPeConfig(**BASE, **kw), device="cpu").build(
            port_graph(graph), params=partition_state_from_reference(ref.models)
        )
        out[name] = {"reference": RD.engine_state(ref), "port": PD.engine_state(port)}
    return out


def clone(pkg, entry):
    """A replica from an in-memory snapshot.  The reference's restore keeps
    the arrays it is given as its tables and writes into them, so it gets
    copies; the port's restore copies them itself."""
    meta, arrays = entry[pkg.name]
    if pkg is REF:
        arrays = {k: v.copy() for k, v in arrays.items()}
    return pkg.restore({**arrays, _META_KEY: np.asarray(json.dumps(meta))})


def stream(g, k, seed=0):
    """``k`` seeded edit batches on ``g`` → [(reference update, port update)]."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        e = g.edge_array()
        arrays = {
            "add_edges": rng.integers(0, g.n_vertices, size=(2, 2)),
            "remove_edges": e[rng.choice(e.shape[0], size=1, replace=False)],
            "add_vertex_labels": np.zeros(0, np.int32),
            "remove_vertices": np.zeros(0, np.int64),
        }
        out.append((RefUpdate.from_arrays(arrays), GraphUpdate.from_arrays(arrays)))
    return out


def ups(pairs, pkg):
    return [p[0] if pkg is REF else p[1] for p in pairs]


def make_queries(g, n=3, seed0=50):
    return [random_connected_query(g, 4, seed=seed0 + s) for s in range(n)]


def identical(a, b, queries):
    return PD.engine_fingerprint(a) == PD.engine_fingerprint(b) and (
        a.match_many(queries) == b.match_many(queries)
    )


def run_until_crash(pkg, eng, durability, updates):
    srv = pkg.Server(eng, pkg.ServeConfig(durability=durability))
    for u in updates:
        srv.submit_update(u)
        try:
            srv.apply_update_tick()
        except pkg.D.SimulatedCrash as e:
            return srv, e.point
    return srv, None


def dir_bytes(d: Path) -> dict:
    return {p.relative_to(d).as_posix(): p.read_bytes() for p in sorted(d.rglob("*.wal"))}


# ------------------------------------------------------------------- WAL ---


def test_frame_and_record_codec_equal_the_reference():
    arrays = {
        "a": np.arange(6, dtype=np.int64).reshape(3, 2),
        "b": np.zeros((0, 2), np.int64),
        "c": np.array([1.5, -2.5], np.float32),
    }
    blob = port_wal.encode_record("epoch", {"epoch": 7, "s": "x"}, arrays)
    assert blob == ref_wal.encode_record("epoch", {"epoch": 7, "s": "x"}, arrays)
    assert port_wal.frame_payload(blob) == ref_wal.frame_payload(blob)
    for decode in (port_wal.decode_record, ref_wal.decode_record):
        rec = decode(blob)
        assert rec.type == "epoch" and rec.meta == {"epoch": 7, "s": "x"} and rec.epoch == 7
        for k, v in arrays.items():
            assert rec.arrays[k].dtype == v.dtype and np.array_equal(rec.arrays[k], v)
    empty = port_wal.decode_record(port_wal.encode_record("unsub", {"sub_id": 1}))
    assert empty.arrays == {} and empty.epoch is None
    with pytest.raises(PD.CorruptRecordError):
        port_wal.decode_record(blob[:-4])
    payload = b"hello wal"
    with pytest.raises(PD.CorruptRecordError):
        PD.unframe_payload(b"XXXX" + PD.frame_payload(payload)[4:])
    torn = PD.frame_payload(payload)[:-3]
    with pytest.raises(PD.CorruptRecordError):
        PD.unframe_payload(torn)


def test_graph_update_arrays_byte_equal_the_reference():
    arrays = {
        "add_edges": [(1, 2), (3, 4)], "remove_edges": np.array([[5, 6]]),
        "add_vertex_labels": np.array([0, 2], np.int32), "remove_vertices": [9],
    }
    p = GraphUpdate(**arrays).to_arrays()
    r = RefUpdate(**arrays).to_arrays()
    for k in r:
        assert p[k].dtype == r[k].dtype and p[k].tobytes() == r[k].tobytes()
    back = GraphUpdate.from_arrays(p).to_arrays()
    assert all(np.array_equal(back[k], p[k]) for k in p)


def test_wal_segments_byte_equal_between_packages(graph, tmp_path):
    """One update stream through each package's ``Durability`` journal
    (epochs, a subscription, an unsubscription, size rotation) leaves
    byte-equal segments; each package reads the other's records."""
    pairs = stream(graph, 6, seed=21)
    q = random_connected_query(graph, 4, seed=5)
    for pkg in (REF, PORT):
        cfg = pkg.D.DurabilityConfig(str(tmp_path / pkg.name), segment_bytes=600, fsync=False)
        dur = pkg.D.Durability(cfg)
        for e, u in enumerate(ups(pairs, pkg), start=1):
            dur.log_epoch(e, [u], "delta", "inline")
            if e == 2:
                dur.log_subscribe(0, q, tenant="t")
            if e == 4:
                dur.log_unsubscribe(0)
        dur.close()
    got, want = dir_bytes(tmp_path / "port"), dir_bytes(tmp_path / "reference")
    assert len(want) > 2 and got == want
    for reader in (PD.WriteAheadLog, RD.WriteAheadLog):
        for other in ("port", "reference"):
            w = reader(tmp_path / other / "wal", segment_bytes=600, fsync=False)
            assert w.open()["records"] == 8
            recs = w.records()
            assert [r.type for r in recs].count("epoch") == 6 and w.last_epoch() == 6
            assert np.array_equal(recs[0].arrays["u0_add_edges"],
                                  pairs[0][0].to_arrays()["add_edges"])
            w.close()


def test_wal_append_reopen_rotate(tmp_path):
    w = PD.WriteAheadLog(tmp_path, segment_bytes=700)
    assert w.open() == {"records": 0, "truncated_bytes": 0, "segments": 0}
    for i in range(8):
        w.append("epoch", {"epoch": i + 1}, {"x": np.full((4, 2), i, np.int64)})
    assert len(w.segments()) > 1 and w.last_epoch() == 8
    w.close()
    w2 = PD.WriteAheadLog(tmp_path, segment_bytes=700)
    assert w2.open()["records"] == 8
    recs = w2.records()
    assert [r.epoch for r in recs] == list(range(1, 9))
    assert np.array_equal(recs[3].arrays["x"], np.full((4, 2), 3, np.int64))
    w2.append("epoch", {"epoch": 9})
    assert w2.last_epoch() == 9
    w2.close()


def test_wal_torn_tail_truncates_as_the_reference(tmp_path):
    w = PD.WriteAheadLog(tmp_path / "src")
    w.open()
    for i in range(5):
        w.append("epoch", {"epoch": i + 1}, {"x": np.arange(8)})
    w.close()
    seg = w.segments()[-1][1]
    with open(seg, "r+b") as f:
        f.truncate(seg.stat().st_size - 9)  # torn mid-frame
    infos = {}
    for name, cls in (("port", PD.WriteAheadLog), ("reference", RD.WriteAheadLog)):
        shutil.copytree(tmp_path / "src", tmp_path / name)
        w2 = cls(tmp_path / name)
        infos[name] = w2.open()
        w2.append("epoch", {"epoch": 5})  # resumes at the last durable epoch
        assert [r.epoch for r in w2.records()] == [1, 2, 3, 4, 5]
        w2.close()
    assert infos["port"] == infos["reference"]
    assert infos["port"]["records"] == 4 and infos["port"]["truncated_bytes"] > 0
    assert dir_bytes(tmp_path / "port") == dir_bytes(tmp_path / "reference")


def test_wal_midstream_corruption_fails_loudly(tmp_path):
    w = PD.WriteAheadLog(tmp_path)
    w.open()
    for i in range(5):
        w.append("epoch", {"epoch": i + 1}, {"x": np.arange(32)})
    w.close()
    seg = w.segments()[-1][1]
    PD.flip_byte(seg, offset=seg.stat().st_size // 3)  # damage an early record
    with pytest.raises(PD.CorruptWalError):
        PD.WriteAheadLog(tmp_path).open()
    with pytest.raises(PD.CorruptWalError):
        PD.WriteAheadLog(tmp_path).records()


def test_wal_corrupt_sealed_segment_fails_loudly(tmp_path):
    w = PD.WriteAheadLog(tmp_path, segment_bytes=400)
    w.open()
    for i in range(6):
        w.append("epoch", {"epoch": i + 1}, {"x": np.arange(16)})
    w.close()
    assert len(w.segments()) >= 2
    first = w.segments()[0][1]
    with open(first, "r+b") as f:  # a torn-looking tail in a sealed segment
        f.truncate(first.stat().st_size - 5)
    with pytest.raises(PD.CorruptWalError):
        PD.WriteAheadLog(tmp_path, segment_bytes=400).open()


def test_wal_prune_keeps_uncovered_and_active(tmp_path):
    w = PD.WriteAheadLog(tmp_path)
    w.open()
    for i in range(4):
        w.append("epoch", {"epoch": i + 1})
        w.rotate()
    w.append("epoch", {"epoch": 5})
    assert w.prune(2) == 2  # a snapshot at epoch 2 supersedes epochs 1-2
    assert [r.epoch for r in w.records()] == [3, 4, 5]
    assert w.prune(100) == 2  # sealed 3, 4 go; the active segment never does
    assert [r.epoch for r in w.records()] == [5]
    w.close()


# ------------------------------------------------------------- snapshots ---


@pytest.mark.parametrize("name", list(CONFIGS))
def test_engine_state_equals_the_reference(base, name):
    (rmeta, rarr), (pmeta, parr) = base[name]["reference"], base[name]["port"]
    assert sorted(parr) == sorted(rarr)
    for k, want in rarr.items():
        got = parr[k]
        assert (got.dtype, got.shape) == (want.dtype, want.shape), k
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    timings = {k for k in rmeta["offline_stats"] if k.endswith("_time")}
    # the port's one meta key of its own: the stacked probe's slot layout
    assert set(pmeta) - set(rmeta) == {_SLOT_KEY}
    assert (pmeta[_SLOT_KEY] is not None) == (CONFIGS[name]["probe_impl"] == "stacked")
    assert {k: v for k, v in pmeta.items() if k not in ("offline_stats", _SLOT_KEY)} == {
        k: v for k, v in rmeta.items() if k != "offline_stats"
    }
    assert sorted(pmeta["offline_stats"]) == sorted(rmeta["offline_stats"])
    for k, v in rmeta["offline_stats"].items():
        if k not in timings:
            assert pmeta["offline_stats"][k] == pytest.approx(v), k


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_snapshot_restores_across_packages(base, graph, tmp_path, name, writer):
    """A dirty engine's snapshot, written to disk by one package and loaded
    by the other, gives the reference's match lists, order included; one
    epoch on (it compacts a partition) the sets stay the reference's.  The
    order may not: the packages' floats agree within 1e-6, not bit for bit,
    and the compaction's Morton sort keys can tell them apart."""
    src, dst = (REF, PORT) if writer == "reference" else (PORT, REF)
    pairs = stream(graph, 4, seed=1)
    eng = clone(src, base[name])
    ref_eng = clone(REF, base[name])
    for p in pairs[:3]:
        eng.apply_updates(ups([p], src))
        ref_eng.apply_updates(ups([p], REF))
    src.D.SnapshotStore(tmp_path).save(eng)
    store = dst.D.SnapshotStore(tmp_path)
    loaded, meta, _, epoch = (
        store.load(device="cpu") if dst is PORT else store.load()
    )
    assert epoch == 3 == loaded.epoch and meta["delta_epoch"] == 3
    qs = make_queries(graph, n=4, seed0=60)
    want = ref_eng.match_many(qs)
    assert loaded.match_many(qs) == want and sum(map(len, want)) > 0
    loaded.apply_updates(ups(pairs[3:], dst))
    ref_eng.apply_updates(ups(pairs[3:], REF))
    assert [sorted(m) for m in loaded.match_many(qs)] == [
        sorted(m) for m in ref_eng.match_many(qs)
    ]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_snapshot_byte_identity(base, graph, name):
    eng = clone(PORT, base[name])
    for u in ups(stream(graph, 3, seed=1), PORT):
        eng.apply_updates([u])
    rt = clone(PORT, {"port": PD.engine_state(eng)})  # round trip of the dirty engine
    assert identical(eng, rt, make_queries(graph))
    u = ups(stream(graph, 1, seed=9), PORT)[0]
    eng.apply_updates([u])
    rt.apply_updates([u])
    assert PD.engine_fingerprint(eng) == PD.engine_fingerprint(rt)


def test_restore_places_tensors_and_fresh_derived_state(base, graph):
    """Everything lands on the device asked for, as copies; the derived
    state starts fresh and the stacked probe stacks again; without a card a
    restore that does not ask for the CPU raises."""
    meta, arrays = base["grouped-stacked"]["port"]
    before = {k: v.copy() for k, v in arrays.items()}
    full = {**arrays, _META_KEY: np.asarray(json.dumps(meta))}
    eng, _ = PD.restore_engine(full, device="cpu")
    m = eng.models[0]
    assert m.index.paths.dtype == torch.int64 and m.index.paths.device.type == "cpu"
    assert eng.dgraph.labels.device.type == "cpu" and eng._perms.dtype == torch.int64
    assert eng._stacked_probe is not None and eng._last_epoch_update is None
    assert not eng._plan_cache and not eng._live_mask_cache and not eng._subset_probes
    assert m.index.groups is not None and m.index.groups.group_size == 4
    for u in ups(stream(graph, 3, seed=2), PORT):
        eng.apply_updates([u])
    assert eng.delta.stats()["tombstones"] > 0
    for k, v in before.items():  # the engine wrote into copies, not the donor's arrays
        np.testing.assert_array_equal(arrays[k], v, err_msg=k)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PD.restore_engine(full)


def test_snapshot_corruption_falls_back(base, graph, tmp_path):
    eng = clone(PORT, base["path-loop"])
    dur = PD.Durability(PD.DurabilityConfig(str(tmp_path), genesis_snapshot=False))
    dur.snapshot(eng)
    eng.apply_updates(ups(stream(graph, 1), PORT))
    dur.snapshot(eng)
    PD.flip_byte(dur.snapshots.mgr._path(eng.epoch), offset=-50)
    _, _, _, epoch = dur.snapshots.load(device="cpu")
    assert epoch == 0  # fell back past the damaged snapshot
    with pytest.raises(CorruptCheckpointError):
        dur.snapshots.load(step=eng.epoch, device="cpu")
    dur.close()


# ------------------------------------------------------------ crash sweep ---


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("point,at", [
    ("before_log", 3),
    ("after_log", 5),       # logged, never applied: the replay covers it
    ("after_apply", 4),
    ("mid_snapshot", 2),    # npz committed, manifest missing: the step is skipped
    ("after_snapshot", 2),  # snapshot committed, rotate and prune never ran
])
def test_crash_recovery_identity(base, graph, tmp_path, name, point, at):
    pairs = stream(graph, 7, seed=3)
    qs = make_queries(graph)
    recovered = {}
    for pkg in (PORT, REF):
        d = tmp_path / pkg.name
        dur = pkg.D.Durability(pkg.D.DurabilityConfig(str(d), snapshot_every=3),
                               crash=pkg.D.CrashPoint(point, at=at))
        _, crashed_at = run_until_crash(pkg, clone(pkg, base[name]), dur, ups(pairs, pkg))
        assert crashed_at == point
        recovered[pkg.name] = pkg.recover(pkg.D.DurabilityConfig(str(d), snapshot_every=3))
    eng, info = recovered["port"]
    assert info["epoch"] == recovered["reference"][1]["epoch"]
    assert info["snapshot_epoch"] == recovered["reference"][1]["snapshot_epoch"]
    control = clone(PORT, base[name])
    for u in ups(pairs[: info["epoch"]], PORT):
        control.apply_updates([u])
    assert identical(eng, control, qs), f"{name}/{point}@{at}"
    assert eng.match_many(qs) == recovered["reference"][0].match_many(qs)
    for u in ups(pairs[info["epoch"]:], PORT):  # the recovered replica keeps serving
        eng.apply_updates([u])
        control.apply_updates([u])
    assert PD.engine_fingerprint(eng) == PD.engine_fingerprint(control)


def test_crash_then_torn_write_recovers(base, graph, tmp_path):
    pairs = stream(graph, 5, seed=4)
    dur = PD.Durability(
        PD.DurabilityConfig(str(tmp_path), snapshot_every=0, genesis_snapshot=False),
        crash=PD.CrashPoint("after_log", at=4),
    )
    victim = clone(PORT, base["path-loop"])
    dur.snapshot(victim)
    run_until_crash(PORT, victim, dur, ups(pairs, PORT))
    seg = sorted((tmp_path / "wal").glob("seg_*.wal"))[-1]
    PD.truncate_tail(seg, 7)  # the epoch-4 record torn mid-frame
    recovered, info = PD.recover_engine(PD.DurabilityConfig(str(tmp_path)), device="cpu")
    assert info["epoch"] == 3 and info["truncated_bytes"] > 0
    control = clone(PORT, base["path-loop"])
    for u in ups(pairs[:3], PORT):
        control.apply_updates([u])
    assert identical(recovered, control, make_queries(graph))


def test_crash_recovery_corrupt_wal_fails_loudly(base, graph, tmp_path):
    dur = PD.Durability(PD.DurabilityConfig(str(tmp_path), snapshot_every=0))
    srv = MatchServer(clone(PORT, base["path-loop"]), MatchServeConfig(durability=dur))
    for u in ups(stream(graph, 4, seed=6), PORT):
        srv.submit_update(u)
        srv.apply_update_tick()
    dur.close()
    seg = sorted((tmp_path / "wal").glob("seg_*.wal"))[-1]
    PD.flip_byte(seg, offset=seg.stat().st_size // 4)
    with pytest.raises((PD.CorruptWalError, PD.RecoveryError)):
        PD.recover_engine(PD.DurabilityConfig(str(tmp_path)), device="cpu")


def test_recovery_without_snapshot_fails_loudly(tmp_path):
    with pytest.raises(PD.RecoveryError):
        PD.recover_engine(PD.DurabilityConfig(str(tmp_path / "nothing")), device="cpu")


def test_recovery_rejects_wal_gap(base, graph, tmp_path):
    victim = clone(PORT, base["path-loop"])
    dur = PD.Durability(
        PD.DurabilityConfig(str(tmp_path), snapshot_every=0, genesis_snapshot=False)
    )
    dur.snapshot(victim)
    for u in ups(stream(graph, 3, seed=8), PORT):
        dur.log_epoch(victim.epoch + 1, [u], "delta", "inline")
        victim.apply_updates([u])
        dur.wal.rotate()  # one epoch a segment
    dur.close()
    os.unlink(sorted((tmp_path / "wal").glob("seg_*.wal"))[1])  # epoch 2 vanishes
    with pytest.raises(PD.RecoveryError, match="gap"):
        PD.recover_engine(PD.DurabilityConfig(str(tmp_path)), device="cpu")


def test_compaction_and_update_slot_before_crash(graph, tmp_path):
    """The grouped stacked probe of a never-crashed engine re-stacks its
    compacted slots in place (``update_slot``); the recovered engine stacks
    afresh.  Their layouts may differ; fingerprints and match lists, order
    included, may not."""
    cfg = GnnPeConfig(**BASE, **CONFIGS["grouped-stacked"], delta_compact_min=6,
                      delta_compact_frac=0.02)
    pairs = stream(graph, 6, seed=31)
    calls = []

    def build():
        eng = GnnPeEngine(cfg, device="cpu").build(port_graph(graph))
        probe = eng.stacked_probe()
        orig = probe.update_slot
        probe.update_slot = lambda i, ix: calls.append(i) or orig(i, ix)
        return eng

    dur = PD.Durability(PD.DurabilityConfig(str(tmp_path), snapshot_every=4),
                        crash=PD.CrashPoint("after_apply", at=5))
    srv, point = run_until_crash(PORT, build(), dur, ups(pairs, PORT))
    assert point == "after_apply" and calls, "no compaction re-stacked a slot before the crash"
    assert srv.engine.delta.n_compactions > 0
    recovered, info = PD.recover_engine(PD.DurabilityConfig(str(tmp_path), snapshot_every=4),
                                        device="cpu")
    assert info["snapshot_epoch"] == 4 and info["epoch"] == 5
    control = build()
    for u in ups(pairs[:5], PORT):
        control.apply_updates([u])
    qs = make_queries(graph, n=5, seed0=80)
    assert identical(recovered, control, qs)
    assert recovered.match_many(qs, join_impl="device") == control.match_many(qs, join_impl="device")
    assert srv.engine.match_many(qs) == recovered.match_many(qs)


def test_restored_handoff_keeps_the_donor_slot_order(tmp_path):
    """A port snapshot carries the stacked probe's slot layout, so an engine
    restored from it lists the hand-off's candidates, and so its matches,
    in its donor's order even where compactions have reordered the
    partitions' sizes since the build (here at epochs 4 and 5).  A snapshot
    without the layout, as the JAX package writes it, stacks afresh."""
    from repro_torch.core.stacked import plan_shards

    g = erdos_renyi(160, avg_degree=3.5, n_labels=4, seed=2)
    cfg = GnnPeConfig(**BASE, index_kind="grouped", probe_impl="stacked", join_impl="device")
    eng = GnnPeEngine(cfg, device="cpu").build(port_graph(g))
    qs = [random_connected_query(g, 4, seed=50 + s) for s in range(4)]
    rng = np.random.default_rng(2)
    reordered = []
    store = PD.SnapshotStore(tmp_path, keep=1)
    for _ in range(5):
        e = eng.graph.edge_array()
        n = eng.graph.n_vertices
        eng.apply_updates(GraphUpdate.from_arrays({
            "add_edges": rng.integers(0, n, size=(6, 2)),
            "remove_edges": e[rng.choice(e.shape[0], size=6, replace=False)],
            "add_vertex_labels": rng.integers(0, 4, size=2).astype(np.int32),
            "remove_vertices": rng.integers(0, n, size=1),
        }))
        live = eng.stacked_probe().stacked.slot_of
        fresh = np.zeros(len(live), np.int64)
        fresh[plan_shards([m.index.n_paths for m in eng.models], 1)[0]] = np.arange(len(live))
        store.save(eng)
        restored, meta, _, _ = store.load(device="cpu")
        assert meta[_SLOT_KEY] == live.tolist()
        np.testing.assert_array_equal(restored.stacked_probe().stacked.slot_of, live)
        assert identical(restored, eng, qs), f"epoch {eng.epoch}"
        if not np.array_equal(live, fresh):
            reordered.append(eng.epoch)
            meta, arrays = PD.engine_state(eng)
            del meta[_SLOT_KEY]  # the JAX package's layout
            plain, _ = PD.restore_engine({**arrays, _META_KEY: np.asarray(json.dumps(meta))},
                                         device="cpu")
            np.testing.assert_array_equal(plain.stacked_probe().stacked.slot_of, fresh)
            assert PD.engine_fingerprint(plain) != PD.engine_fingerprint(eng)
            assert [sorted(m) for m in plain.match_many(qs)] == [
                sorted(m) for m in eng.match_many(qs)]
    assert reordered == [4, 5]


@pytest.mark.parametrize("reader", ["stacked_match_many", "cluster_engine"])
def test_fingerprint_unmoved_by_a_stacked_read(tmp_path, reader):
    """The fingerprint covers the slot layout the next stacked probe runs
    on, so the read that first builds that probe leaves it as it was: a
    replica that served a stacked read fingerprints as one that served none,
    and so does its restore."""
    g = erdos_renyi(160, avg_degree=3.5, n_labels=4, seed=2)
    probe = "loop" if reader == "stacked_match_many" else "stacked"
    cfg = GnnPeConfig(**BASE, index_kind="grouped", probe_impl=probe, join_impl="device")
    eng = GnnPeEngine(cfg, device="cpu").build(port_graph(g))
    rng = np.random.default_rng(2)
    for _ in range(4):  # past the epoch where compactions reorder the sizes
        e = eng.graph.edge_array()
        n = eng.graph.n_vertices
        eng.apply_updates(GraphUpdate.from_arrays({
            "add_edges": rng.integers(0, n, size=(6, 2)),
            "remove_edges": e[rng.choice(e.shape[0], size=6, replace=False)],
            "add_vertex_labels": rng.integers(0, 4, size=2).astype(np.int32),
            "remove_vertices": rng.integers(0, n, size=1),
        }))
    # a stacked engine holds no probe once a compaction outgrows its slot
    eng._stacked_probe = None
    meta, arrays = PD.engine_state(eng)
    twin, _ = PD.restore_engine({**arrays, _META_KEY: np.asarray(json.dumps(meta))},
                                device="cpu")
    assert eng._stacked_probe is None and twin._stacked_probe is None
    before = PD.engine_fingerprint(eng)
    assert PD.engine_fingerprint(twin) == before
    qs = [random_connected_query(g, 4, seed=50 + s) for s in range(4)]
    if reader == "stacked_match_many":
        got = eng.match_many(qs, probe_impl="stacked", join_impl="device")
        assert eng._stacked_probe is not None
    else:
        got = ClusterEngine(eng, n_hosts=2).match_many(qs)
        assert eng._stacked_probe is not None
    assert [sorted(m) for m in got] == [sorted(m) for m in twin.match_many(qs)]
    assert PD.engine_fingerprint(eng) == before == PD.engine_fingerprint(twin)
    store = PD.SnapshotStore(tmp_path, keep=1)
    store.save(eng)
    restored, _, _, _ = store.load(device="cpu")
    assert PD.engine_fingerprint(restored) == before


def test_reference_directory_recovers_in_the_port(base, graph, tmp_path):
    """A directory the reference's ``MatchServer`` wrote (genesis, cadenced
    snapshots, a subscription, a crash after a logged epoch) recovers in the
    port to the reference's lists and subscription table."""
    pairs = stream(graph, 6, seed=41)
    q = random_connected_query(graph, 4, seed=71)
    dur = RD.Durability(RD.DurabilityConfig(str(tmp_path), snapshot_every=2),
                        crash=RD.CrashPoint("after_log", at=5))
    srv = ref_ms.MatchServer(clone(REF, base["grouped-stacked"]),
                             ref_ms.MatchServeConfig(durability=dur))
    sid = srv.subscribe(q, tenant="acme")
    with pytest.raises(RD.SimulatedCrash):
        for u in ups(pairs, REF):
            srv.submit_update(u)
            srv.apply_update_tick()
    ref_rec, ref_info = RD.recover_engine(RD.DurabilityConfig(str(tmp_path)))
    port_rec, info = PD.recover_engine(PD.DurabilityConfig(str(tmp_path)), device="cpu")
    assert info["epoch"] == ref_info["epoch"] == 5 and info["replayed"] == ref_info["replayed"]
    assert sorted(info["subscriptions"]) == [sid] and info["subscriptions"][sid][1] == "acme"
    qs = make_queries(graph, n=4, seed0=90)
    assert port_rec.match_many(qs) == ref_rec.match_many(qs)


# ---------------------------------------------------------------- serving ---


def test_standing_reregistration_exactly_once(base, graph, tmp_path):
    pairs = stream(graph, 6, seed=12)
    qs = make_queries(graph, n=2, seed0=70)
    dur = PD.Durability(PD.DurabilityConfig(str(tmp_path), snapshot_every=3),
                        crash=PD.CrashPoint("after_apply", at=5))
    srv = MatchServer(clone(PORT, base["grouped-stacked"]), MatchServeConfig(durability=dur))
    sids = [srv.subscribe(q) for q in qs]
    for u in ups(pairs, PORT):
        srv.submit_update(u)
        try:
            srv.apply_update_tick()
        except PD.SimulatedCrash:
            break
    rec_srv, info = PD.recover_server(PD.DurabilityConfig(str(tmp_path), snapshot_every=3),
                                      device="cpu")
    assert sorted(info["subscriptions"]) == sorted(sids)  # the original ids survive
    oracle = clone(PORT, base["grouped-stacked"])
    for u in ups(pairs[: info["epoch"]], PORT):
        oracle.apply_updates([u])
    for sid, ref in zip(sids, oracle.match_many(qs)):
        assert len(rec_srv.match_deltas[sid]) == 1  # the registration-time refresh alone
        assert rec_srv.standing_matches(sid) == sorted(set(ref))
    assert len(rec_srv.durability.wal.records()) == len(dur.wal.records())  # not re-journaled
    for u in ups(pairs[info["epoch"]:], PORT):
        rec_srv.submit_update(u)
        rec_srv.apply_update_tick()
        oracle.apply_updates([u])
    for sid, ref in zip(sids, oracle.match_many(qs)):
        got = set()
        for d in rec_srv.match_deltas[sid]:
            got = (got - set(d.retracted)) | set(d.added)
        assert set(rec_srv.standing_matches(sid)) == got == {tuple(map(int, m)) for m in ref}


def test_unsubscribe_survives_recovery(base, graph, tmp_path):
    dur = PD.Durability(PD.DurabilityConfig(str(tmp_path), snapshot_every=0))
    srv = MatchServer(clone(PORT, base["path-loop"]), MatchServeConfig(durability=dur))
    q1, q2 = make_queries(graph, n=2, seed0=90)
    s1, s2 = srv.subscribe(q1), srv.subscribe(q2)
    assert srv.unsubscribe(s1)
    srv.submit_update(ups(stream(graph, 1, seed=13), PORT)[0])
    srv.apply_update_tick()
    dur.close()
    _, info = PD.recover_server(PD.DurabilityConfig(str(tmp_path)), device="cpu")
    assert sorted(info["subscriptions"]) == [s2]


def test_server_genesis_and_durable_restart(base, graph, tmp_path):
    eng = clone(PORT, base["path-loop"])
    cfg = PD.DurabilityConfig(str(tmp_path), snapshot_every=2)
    MatchServer(eng, MatchServeConfig(durability=cfg))
    recovered, info = PD.recover_engine(cfg, device="cpu")
    assert info["epoch"] == 0 and info["replayed"] == 0
    assert identical(recovered, eng, make_queries(graph))
    if not torch.cuda.is_available():  # nothing falls back to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PD.recover_engine(cfg)


def test_service_journals_through_its_server(base, graph, tmp_path):
    """``ServiceConfig.durability`` reaches the inner server: every update
    tick is journaled, and recovery gives the service's engine."""
    pairs = stream(graph, 3, seed=17)
    qs = make_queries(graph, n=3, seed0=40)
    eng = clone(PORT, base["path-loop"])
    cfg = PD.DurabilityConfig(str(tmp_path), snapshot_every=2)

    async def go():
        svc = MatchService(eng, ServiceConfig(durability=cfg, idle_tick_s=0.01,
                                              max_updates_per_tick=1))
        await svc.start()
        for u in ups(pairs, PORT):
            svc.submit_update(u)
        await svc.drain()
        resps = await asyncio.gather(*(svc.submit(q)[1] for q in qs))
        await svc.stop()
        return svc, resps

    svc, resps = asyncio.run(asyncio.wait_for(go(), 60.0))
    assert svc.server.durability is not None and eng.epoch == 3
    recovered, info = PD.recover_engine(cfg, device="cpu")
    assert info["epoch"] == 3 and info["snapshot_epoch"] == 2
    assert PD.engine_fingerprint(recovered) == PD.engine_fingerprint(eng)
    assert [r.matches for r in resps] == recovered.match_many(qs)


def test_cluster_engine_logs_before_it_applies(base, graph, tmp_path):
    pairs = stream(graph, 3, seed=19)
    eng = clone(PORT, base["grouped-stacked"])
    cfg = PD.DurabilityConfig(str(tmp_path), snapshot_every=0)
    dur = PD.Durability(cfg, crash=PD.CrashPoint("after_log", at=3))
    cl = ClusterEngine(eng, n_hosts=2, cache_capacity=8, durability=dur)
    assert dur.snapshots.latest_epoch() == 0  # the coordinator's genesis snapshot
    qs = make_queries(graph)
    cl.apply_updates(ups(pairs, PORT)[0])
    cl.apply_updates(ups(pairs, PORT)[1:2])
    with pytest.raises(PD.SimulatedCrash):
        cl.apply_updates(ups(pairs, PORT)[2])
    assert eng.epoch == 2  # logged, never applied
    recovered, info = PD.recover_engine(cfg, device="cpu")
    assert info["epoch"] == 3 and info["replayed"] == 3
    eng.apply_updates(ups(pairs, PORT)[2:])
    assert identical(recovered, eng, qs)
    assert ClusterEngine(recovered, n_hosts=2).match_many(qs) == eng.match_many(qs)


def test_simulated_crash_is_no_device_fault():
    """A ``BaseException``: no ``except Exception`` boundary absorbs it, and
    the tiers' device-fault test does not claim it."""
    exc = PD.SimulatedCrash("after_log")
    assert not isinstance(exc, Exception) and not is_device_fault(exc)
    assert PD.faults.KILL_POINTS == RD.faults.KILL_POINTS


# ------------------------------------------------------------------ scrub ---


def test_scrub_clean_and_planted_faults(base, graph):
    eng = clone(PORT, base["grouped-stacked"])
    for u in ups(stream(graph, 2, seed=14), PORT):
        eng.apply_updates([u])
    report = PD.scrub_engine(eng)
    assert report["ok"] and report["partitions_checked"] == [0, 1, 2]
    assert set(report) == {"ok", "violations", "partitions_checked", "epoch", "scrub_s"}
    eng.models[0].index.levels[0]["mbr"][0, 0, 1] -= 10  # a narrowed MBR
    eng.models[1].index.groups.mbr_hi[0, 0] -= 1  # a narrowed group bound
    checks = {(v["partition"], v["check"]) for v in PD.scrub_engine(eng)["violations"]}
    assert (0, "mbr") in checks and (1, "groups") in checks

    eng2 = clone(PORT, base["path-loop"])
    eng2.apply_updates(ups(stream(graph, 1, seed=15), PORT))
    eng2.delta.parts[0].n_tomb += 1  # bookkeeping drift
    dp = eng2.delta.parts[2]
    dp.paths = torch.cat([dp.paths, eng2.models[2].index.paths[:1].flip(1) + 10_000])
    dp.emb, dp.emb0 = torch.cat([dp.emb, dp.emb[:1]]), torch.cat([dp.emb0, dp.emb0[:1]])
    checks = {(v["partition"], v["check"]) for v in PD.scrub_engine(eng2)["violations"]}
    assert (0, "tombstone") in checks and (2, "enumerate") in checks and (2, "delta") in checks


def test_scrub_sample_and_server_admin_call(base):
    eng = clone(PORT, base["path-loop"])
    srv = MatchServer(eng, MatchServeConfig())
    report = srv.scrub(sample=2)
    want = sorted(np.random.default_rng(0).choice(3, size=2, replace=False).tolist())
    assert report["ok"] and report["partitions_checked"] == want


def test_scrub_cli_exit_codes(base, tmp_path, capsys):
    eng = clone(PORT, base["grouped-stacked"])
    clean = PD.DurabilityConfig(str(tmp_path / "clean"))
    PD.Durability(clean).snapshot(eng)
    assert PD.scrub.main(["--dir", clean.directory, "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["recovered_epoch"] == 0
    eng.models[2].index.groups.mbr_hi[1, 1] += 0.5  # stored as it is: survives the restore
    bad = PD.DurabilityConfig(str(tmp_path / "bad"))
    PD.Durability(bad).snapshot(eng)
    assert PD.scrub.main(["--dir", bad.directory, "--device", "cpu", "--sample", "3"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert [v["check"] for v in report["violations"]] == ["groups"]


# ---------------------------------------------------------------- example ---

_FINAL = re.compile(r"\[wal\] final epoch=(\d+) fingerprint=(\w+) match_digest=(\w+)")


def _example(wal_dir, kill_epoch=None):
    cmd = [sys.executable, str(ROOT / "examples" / "serve_queries_torch.py"), "--device", "cpu",
           "--n", "600", "--wal", str(wal_dir), "--wal-updates", "5", "--snapshot-every", "2"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    if kill_epoch is None:
        out = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=240)
        assert out.returncode == 0, out.stderr
        return out.stdout
    p = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                         text=True)
    try:
        for line in p.stdout:
            if f"[wal] epoch {kill_epoch}/" in line:
                os.kill(p.pid, signal.SIGKILL)
                break
    finally:
        p.stdout.close()
        rc = p.wait(timeout=60)
    assert rc == -signal.SIGKILL, f"the victim ended with {rc} before epoch {kill_epoch}"
    return None


def test_example_wal_resumes_after_sigkill(tmp_path):
    """``serve_queries_torch.py --wal``: killed after epoch 3, then resumed
    from its directory, it prints the final line of a run never killed."""
    control = _FINAL.search(_example(tmp_path / "control"))
    _example(tmp_path / "victim", kill_epoch=3)
    resumed = _example(tmp_path / "victim")
    assert "[wal] recovered:" in resumed
    got = _FINAL.search(resumed)
    assert control and got and got.groups() == control.groups()
    assert got.group(1) == "5"
