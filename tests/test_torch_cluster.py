"""The port's cluster tier (``dist/placement.py``, the engine's
``partition_stats`` / ``probe_candidates`` / generations, ``dist/cluster.py``,
``serve/cache.py::ShardedResultCache``, ``serve/router.py``), held against
the JAX package on the CPU.

Placement equals the reference's on the same costs and keeps the Graham
bound; the per-partition counters and the parts-scoped candidates equal the
reference engine's under pending buffers and tombstones; cluster lists equal
the port's single-process lists and the reference cluster's for every probe,
join, index kind and plan weight; subset probes follow every install; a lost
host is re-probed; the sharded cache homes and evicts as the reference's;
blue-green generations swap and refuse a stale install; exchange blobs and
candidates cross between the packages; and a two-process run over the
exchange equals ``match_many``.  Engines are built from the reference's
weights (``convert``) on its 150-vertex graph in 3 partitions."""
import itertools
import os
import subprocess
import sys
import tempfile
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import GraphUpdate as RefUpdate  # noqa: E402
from repro.dist import cluster as RC  # noqa: E402
from repro.dist.checkpoint import CheckpointManager as RefCheckpoints  # noqa: E402
from repro.dist.placement import PartitionCost as RefCost  # noqa: E402
from repro.dist.placement import place_partitions as ref_place  # noqa: E402
from repro.graphs import erdos_renyi  # noqa: E402
from repro.serve.cache import ShardedResultCache as RefSharded  # noqa: E402
from repro_torch.core import GnnPeConfig, GnnPeEngine, GraphUpdate  # noqa: E402
from repro_torch.dist import (  # noqa: E402
    CheckpointManager,
    ClusterEngine,
    CorruptCheckpointError,
    DirExchange,
    ExchangeHost,
    HostLostError,
    LocalHost,
    PartitionCost,
    init_distributed,
    partition_costs,
    place_partitions,
    serve_exchange_host,
)
from repro_torch.serve import ClusterRouter, ShardedResultCache  # noqa: E402
from test_torch_delta import engines, port_graph, queries, rand_update  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for the module: test files run in several processes
    at once, and each process's full thread pool would oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graph():
    return erdos_renyi(150, avg_degree=3.5, n_labels=4, seed=5)


def port_engine(g, **fields):
    cfg = dict(dict(n_partitions=3, encoder="monotone", n_multi=1, block_size=32, group_size=4),
               **fields)
    return GnnPeEngine(GnnPeConfig(**cfg), device="cpu").build(port_graph(g))


def assert_candidates_equal(got: dict, want: dict):
    assert list(got) == list(want)
    for key, (main, dverts) in want.items():
        for a, b in zip(got[key], (main, dverts)):
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b)


def epochs(ref, eng, rng, n: int, **kw):
    """``n`` seeded update epochs applied to both engines (or clusters)."""
    for _ in range(n):
        graph_of = getattr(eng, "engine", eng).graph
        ru, pu = rand_update(rng, graph_of, **kw)
        ref.apply_updates(ru)
        eng.apply_updates(pu)


# ----------------------------------------------------------- placement ----


def skewed_costs(kind: int, rng):
    n_parts = int(rng.integers(1, 40))
    if kind == 0:  # power-law skew
        vals = (1000.0 / (1 + np.arange(n_parts))) ** 2
    elif kind == 1:  # one giant, many tiny
        vals = np.ones(n_parts)
        vals[0] = 1e6
    elif kind == 2:
        vals = rng.uniform(0.0, 100.0, n_parts)
    else:  # ties everywhere: the part-id and host-id tie breaks decide
        vals = np.full(n_parts, 5.0)
    return vals


@pytest.mark.parametrize("kind", [0, 1, 2, 3])
def test_placement_equals_reference_and_keeps_graham_bound(kind):
    """``place_partitions`` gives the reference's host map, loads and bound on
    the same costs, and max host load stays within total / n + max cost."""
    rng = np.random.default_rng(kind)
    for _ in range(12):
        vals = skewed_costs(kind, rng)
        n_hosts = int(rng.integers(1, 9))
        got = place_partitions([PartitionCost(i, float(v)) for i, v in enumerate(vals)], n_hosts)
        want = ref_place([RefCost(i, float(v)) for i, v in enumerate(vals)], n_hosts)
        np.testing.assert_array_equal(got.host_of, want.host_of)
        np.testing.assert_array_equal(got.loads, want.loads)
        assert got.as_dict() == want.as_dict()
        assert got.balanced() and got.max_load() <= got.bound + 1e-9
        owned = sorted(sum((got.owned(h) for h in range(n_hosts)), []))
        assert owned == list(range(len(vals)))
    cold = partition_costs([{"part_id": i, "rows": 0} for i in range(4)])
    assert place_partitions(cold, 8).balanced()
    with pytest.raises(ValueError, match="n_hosts"):
        place_partitions(cold, 0)


# --------------------------------------------- the engine's cluster surface ----


@pytest.mark.parametrize("probe,join", [("loop", "numpy"), ("stacked", "numpy"),
                                        ("stacked", "device")])
def test_partition_stats_equal_reference(graph, probe, join):
    """The seven keys of ``partition_stats`` equal the reference engine's
    after the same batches and updates, on both probes and the hand-off."""
    ref, (eng,) = engines(graph, probe_impl=probe, join_impl=join)
    assert eng.partition_stats() == ref.partition_stats()
    qs = queries(graph, n=4)
    rng = np.random.default_rng(2)
    for _ in range(2):
        assert eng.match_many(qs) == ref.match_many(qs)
        epochs(ref, eng, rng, 1, add=3, remove=3)
    eng.match_many(qs)
    ref.match_many(qs)
    got, want = eng.partition_stats(), ref.partition_stats()
    assert got == want
    assert sum(s["probe_rows"] for s in got) > 0 and sum(s["delta_rows"] for s in got) > 0
    assert (sum(s["leaf_pairs"] for s in got) > 0) == (probe == "stacked")


@pytest.mark.parametrize("probe,kind", [("loop", "path"), ("stacked", "path"),
                                        ("stacked", "grouped")])
def test_probe_candidates_equal_reference(graph, probe, kind):
    """``probe_candidates`` gives the reference's keys and int32 arrays (and
    stats) for every partition and for a proper subset, with pending buffers
    and tombstones; the subset's entries are the full probe's."""
    ref, (eng,) = engines(graph, probe_impl=probe, index_kind=kind, delta_compact_min=10**9)
    epochs(ref, eng, np.random.default_rng(5), 2, add=4, remove=4)
    assert eng.delta_stats()["tombstones"] > 0 and eng.delta_stats()["delta_rows"] > 0
    qs = queries(graph, n=4)
    reqs = [(qi, p) for qi, q in enumerate(qs) for p in [tuple(range(3)), (1, 0, 2), (2, 1, 0)]]
    full = None
    for parts in (None, [2, 0]):
        got, gst = eng.probe_candidates(qs, reqs, parts=parts, return_stats=True)
        want, wst = ref.probe_candidates(qs, reqs, parts=parts, return_stats=True)
        assert_candidates_equal(got, want)
        assert gst == wst
        if parts is None:
            full = got
        else:
            assert {k[0] for k in got} == {0, 2}
            for key, arrays in got.items():
                for a, b in zip(arrays, full[key]):
                    np.testing.assert_array_equal(a, b)
    assert any(d.shape[0] for _, d in full.values())
    assert eng.partition_stats() == ref.partition_stats()


# ------------------------------------------------- scatter-gather identity ----

COMBOS = list(itertools.product(("loop", "stacked"), ("numpy", "device"), ("path", "grouped"),
                                ("deg", "dr")))


@pytest.mark.parametrize("probe,join,kind,weight", COMBOS)
def test_cluster_lists_equal_single_process_and_reference(graph, probe, join, kind, weight):
    """Cluster ``match_many`` at 1, 2 and 4 hosts equals the port's
    single-process lists at every delta epoch (buffers and tombstones
    pending) and, on the host join, the reference cluster's lists."""
    fields = dict(probe_impl=probe, join_impl=join, index_kind=kind, plan_weight=weight,
                  delta_compact_min=10**9)
    ref_eng, (eng,) = engines(graph, **fields)
    qs = queries(graph, n=4)
    rng = np.random.default_rng(3)
    for n_hosts in (1, 2, 4):
        cl = ClusterEngine(eng, n_hosts=n_hosts)
        ref = RC.ClusterEngine(ref_eng, n_hosts=n_hosts) if join == "numpy" else None
        for _ in range(2):
            got = cl.match_many(qs)
            assert got == eng.match_many(qs), n_hosts
            if ref is not None:
                assert got == ref.match_many(qs), n_hosts
            epochs(ref_eng, cl, rng, 1, add=3, remove=2)
        assert cl.rebalance().balanced()
        assert all(h.owned for h in cl.hosts[: min(n_hosts, 3)])
    assert eng.delta_stats()["delta_rows"] > 0


def test_cluster_device_join_equals_reference_cluster(graph):
    """The device join under the stacked probe: the coordinator's slot-order
    assembly gives the reference cluster's lists at 2 hosts, with buffers."""
    ref_eng, (eng,) = engines(graph, probe_impl="stacked", join_impl="device")
    qs = queries(graph, n=4)
    cl, ref = ClusterEngine(eng, n_hosts=2), RC.ClusterEngine(ref_eng, n_hosts=2)
    assert cl.match_many(qs) == ref.match_many(qs) == eng.match_many(qs)
    epochs(ref_eng, cl, np.random.default_rng(9), 1, add=3, remove=2)
    assert cl.match_many(qs) == ref.match_many(qs) == eng.match_many(qs)


@pytest.mark.parametrize("install", ["inline", "deferred", "rebuild_indexes", "rebuild_strategy",
                                     "generation"])
def test_subset_probe_follows_every_install(graph, install):
    """A host's subset stack is dropped whenever an install replaces an index
    object; the next probe stacks the new indexes, and the lists stay equal
    to single-process ``match_many``."""
    eng = port_engine(graph, probe_impl="stacked", delta_compact_min=6, delta_compact_frac=0.02)
    qs = queries(graph, n=4)
    cl = ClusterEngine(eng, n_hosts=2)
    assert cl.match_many(qs) == eng.match_many(qs)
    assert eng._subset_probes
    rng = np.random.default_rng(11)
    _, pu = rand_update(rng, eng.graph, add=6, remove=6)
    if install == "inline":
        s = cl.apply_updates(pu)
        assert s["compacted"]
    elif install == "deferred":
        cl.apply_updates(pu, compaction="defer")
        assert eng.pending_compactions()
        assert cl.match_many(qs) == eng.match_many(qs)  # the stacks before the install
        for mi in eng.pending_compactions():
            snap = eng.prepare_compaction(mi)
            assert eng.install_compaction(snap, eng.build_compaction(snap))
    elif install == "rebuild_indexes":
        cl.apply_updates(pu)
        eng.match_many(qs)
        cl.match_many(qs)
        eng.rebuild_indexes()
    elif install == "rebuild_strategy":
        cl.apply_updates(pu, strategy="rebuild")
    else:
        cl.apply_updates(pu)
        cl.match_many(qs)
        assert cl.rebuild_generation()["installed"]
    assert not eng._subset_probes
    assert cl.match_many(qs) == eng.match_many(qs)
    for parts, probe in eng._subset_probes.items():
        assert all(ix is eng.models[mi].index for mi, ix in zip(parts, probe._indexes))


def test_host_loss_is_reprobed_locally(graph):
    """A host lost mid-gather (injected, or an exchange that times out) is
    re-probed by the coordinator: the lists stay equal and ``host_losses``
    counts each loss."""
    eng = port_engine(graph, probe_impl="stacked")
    qs = queries(graph, n=4)
    cl = ClusterEngine(eng, n_hosts=3)
    cl.apply_updates(rand_update(np.random.default_rng(9), eng.graph)[1])
    for h in cl.hosts:
        h.fail_next = True
    assert cl.match_many(qs) == eng.match_many(qs)
    assert cl.stats["host_losses"] == 3
    assert cl.match_many(qs) == eng.match_many(qs)
    assert cl.stats["host_losses"] == 3  # losses are transient
    with tempfile.TemporaryDirectory() as root:
        silent = ExchangeHost(1, DirExchange(root), timeout=0.05)
        cl2 = ClusterEngine(eng, hosts=[LocalHost(0, eng), silent])
        assert silent.owned
        assert cl2.match_many(qs) == eng.match_many(qs)
        assert cl2.stats["host_losses"] == 1
        with pytest.raises(HostLostError):
            DirExchange(root).get("never_written", timeout=0.05, poll=0.01)
        (Path(root) / "torn.npz").write_bytes(b"GWR1\x10\x00")
        with pytest.raises(HostLostError, match="corrupt"):
            DirExchange(root).get("torn", timeout=0.05)


# -------------------------------------------------------- sharded cache ----


def test_sharded_cache_homing_and_locality_equal_reference():
    """The unit contract step by step beside the reference's cache: homes,
    owner-local eager evictions, lazy evictions at ``get`` and rule 2's
    remote evictions."""
    m = np.zeros((1, 3), np.int32)
    caches = [ShardedResultCache(3, capacity=8), RefSharded(3, capacity=8)]
    trail = []
    for c in caches:
        c.set_placement([2, 0, 1])
        t = [c.put(b"k1", m, {0}, {7}, epoch=0), c.put(b"k2", m, {1, 2}, {7}, epoch=0),
             c.put(b"k3", m, {0, 1}, {7}, epoch=0), c.put(b"k4", m, set(), {9}, epoch=0)]
        t.append(c.get(b"k1") is not None)
        t.append(c.invalidate({1: {"deleted": True, "inserted_hashes": []}}))
        t += [c.get(b"k2") is None, c.get(b"k3") is None, c.get(b"k1") is not None]
        t.append(c.invalidate({2: {"deleted": False, "inserted_hashes": np.asarray([9])}}))
        t += [c.get(b"k4") is None, len(c), c.home_shard({1, 2}), c.invalidate({})]
        t.append(c.locality())
        t.append(c.stats_dict())
        trail.append(t)
    assert trail[0] == trail[1]
    assert trail[0][:4] == [2, 0, 2, 0] and trail[0][5] == 1
    loc = trail[0][-2]
    assert (loc["local_evictions"], loc["remote_evictions"], loc["lazy_evictions"]) == (1, 1, 1)
    with pytest.raises(ValueError, match="n_shards"):
        ShardedResultCache(0)


def test_sharded_cache_partition_local_stream_equals_reference(graph):
    """A 3-host cluster with the sharded cache serves repeats from the cache;
    deletions inside partition 0 evict on its owner's shard only
    (``remote_evictions == 0``), with the reference cluster's split, hits
    and lists."""
    ref_eng, (eng,) = engines(graph, probe_impl="stacked")
    qs = queries(graph, n=6)
    cl = ClusterEngine(eng, n_hosts=3, cache_capacity=64)
    ref = RC.ClusterEngine(ref_eng, n_hosts=3, cache_capacity=64)
    first = cl.match_many(qs)
    assert first == ref.match_many(qs) and cl.match_many(qs) == first == ref.match_many(qs)
    assert cl.cache.stats.hits >= len(qs)
    p0 = set(int(v) for v in eng.models[0].members)
    local = np.array([e for e in eng.graph.edge_array().tolist()
                      if e[0] in p0 and e[1] in p0][:4], np.int64)
    assert local.size
    cl.apply_updates(GraphUpdate(remove_edges=local))
    ref.apply_updates(RefUpdate(remove_edges=local))
    loc = cl.cache.locality()
    assert loc == ref.cache.locality()
    assert loc["local_evictions"] > 0 and loc["remote_evictions"] == 0
    got = cl.match_many(qs)
    assert got == eng.match_many(qs) == ref.match_many(qs)
    assert cl.cluster_stats()["cache"] == ref.cluster_stats()["cache"]


# ----------------------------------------------------------- blue-green ----


def test_blue_green_swap_conflict_and_artifacts(graph, tmp_path):
    """``rebuild_generation`` persists the generation (artifacts equal to the
    reference's for the same updates, and ``load_generation``'s indexes
    field-equal to the installed ones), drains the buffers and keeps every
    list; an update between snapshot and install fails the install, and the
    bounded retry succeeds."""
    ref_eng, (eng,) = engines(graph, probe_impl="stacked", index_kind="grouped")
    qs = queries(graph, n=4)
    cl = ClusterEngine(eng, n_hosts=2)
    ref = RC.ClusterEngine(ref_eng, n_hosts=2)
    rng = np.random.default_rng(5)
    epochs(ref, cl, rng, 1)
    before = [sorted(m) for m in eng.match_many(qs)]
    store, ref_store = CheckpointManager(tmp_path / "port"), RefCheckpoints(tmp_path / "ref")
    out = cl.rebuild_generation(store=store)
    assert out == ref.rebuild_generation(store=ref_store) == {"generation": 2, "installed": True}
    assert store.latest_step() == 2
    got, _ = store.restore_arrays()
    want, _ = ref_store.restore_arrays()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
    assert eng.delta_stats()["delta_rows"] == 0 and eng.delta_stats()["tombstones"] == 0
    assert [sorted(m) for m in cl.match_many(qs)] == before
    assert cl.match_many(qs) == eng.match_many(qs) == ref.match_many(qs)
    loaded = cl.load_generation(store)
    assert loaded["generation"] == 2
    for ix, m in zip(loaded["indexes"], eng.models):
        np.testing.assert_array_equal(ix.paths.numpy(), m.index.paths.numpy())
        for name in ("emb", "emb0", "emb_multi"):
            assert torch.equal(getattr(ix, name), getattr(m.index, name))
        assert len(ix.levels) == len(m.index.levels)
        for a, b in zip(ix.levels, m.index.levels):
            assert all(torch.equal(a[k], b[k]) for k in ("mbr", "mbr0", "mbr_multi"))
        for k in ("group_start", "mbr_hi", "mbr0", "block_group_start"):
            assert torch.equal(getattr(ix.groups, k), getattr(m.index.groups, k))
    # the reference's artifacts load into the port's indexes too
    for ix, m in zip(cl.load_generation(ref_store)["indexes"], eng.models):
        np.testing.assert_array_equal(ix.paths.numpy(), m.index.paths.numpy())
    # a stale install is refused; the bounded retry takes a new snapshot
    snap = eng.prepare_generation()
    built = eng.build_generation(snap)
    epochs(ref, cl, rng, 1)
    assert eng.install_generation(snap, built) is False
    assert eng.delta_stats()["delta_rows"] > 0
    assert cl.rebuild_generation()["installed"]
    assert cl.match_many(qs) == eng.match_many(qs)
    # a bit-flipped artifact is refused, not installed
    path = store._path(2)
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0x40
    path.write_bytes(bytes(data))
    with pytest.raises(CorruptCheckpointError):
        cl.load_generation(store, generation=2)


# ------------------------------------------------------ the exchange wire ----


def test_dir_exchange_blobs_cross_between_packages(tmp_path):
    """A blob the reference frames and writes is read by the port and the
    other way round; the candidate packing round-trips; a corrupt frame is a
    host loss."""
    from repro_torch.dist import cluster as PC

    meta = {"keys": [[0, 1, [2, 0, 1]]], "x": 3}
    arrays = {"k0_m": np.arange(6, dtype=np.int32).reshape(2, 3),
              "k0_d": np.zeros((0, 3), np.int32)}
    RC.DirExchange(tmp_path).put("from_ref", meta, arrays)
    DirExchange(tmp_path).put("from_port", meta, arrays)
    for reader, key in ((DirExchange, "from_ref"), (RC.DirExchange, "from_port")):
        got_meta, got = reader(tmp_path).get(key, timeout=1.0)
        assert got_meta == meta and sorted(got) == sorted(arrays)
        for k, v in arrays.items():
            np.testing.assert_array_equal(got[k], v)
    assert (tmp_path / "from_ref.npz").read_bytes() == (tmp_path / "from_port.npz").read_bytes()
    cands = PC._unpack_candidates(*PC._pack_candidates(RC._unpack_candidates(meta, arrays)))
    assert list(cands) == [(0, 1, (2, 0, 1))]
    blob = bytearray((tmp_path / "from_port.npz").read_bytes())
    blob[-1] ^= 1
    (tmp_path / "flipped.npz").write_bytes(bytes(blob))
    with pytest.raises(HostLostError, match="CRC"):
        DirExchange(tmp_path).get("flipped", timeout=1.0)


@pytest.mark.parametrize("worker", ["port", "reference"])
def test_exchange_host_threaded_round_trip(graph, worker):
    """A cluster of a ``LocalHost`` and an ``ExchangeHost`` whose worker (a
    port replica, or the reference engine) answers on a thread equals the
    single-process lists, grouped dr plans included, before and after an
    update epoch; the worker's candidates are the coordinator's own."""
    fields = dict(probe_impl="stacked", index_kind="grouped", plan_weight="dr")
    ref_eng, (eng, replica) = engines(graph, n_port=2, **fields)
    replica = replica if worker == "port" else ref_eng
    qs = queries(graph, n=4)
    with tempfile.TemporaryDirectory() as root:
        ex = DirExchange(root)
        t = threading.Thread(target=(serve_exchange_host if worker == "port"
                                     else RC.serve_exchange_host),
                             args=(replica, 1, ex), kwargs={"timeout": 60.0})
        t.start()
        cl = ClusterEngine(eng, hosts=[LocalHost(0, eng), ExchangeHost(1, ex, timeout=60.0)])
        try:
            assert cl.hosts[1].owned
            assert cl.match_many(qs) == eng.match_many(qs)
            ru, pu = rand_update(np.random.default_rng(6), eng.graph)
            cl.apply_updates(pu)
            replica.apply_updates(pu if worker == "port" else ru)
            assert cl.match_many(qs) == eng.match_many(qs)
            reqs = [(0, (0, 1, 2))]
            assert_candidates_equal(cl.hosts[1].probe(qs, reqs),
                                    eng.probe_candidates(qs, reqs, parts=cl.hosts[1].owned))
        finally:
            cl.shutdown()
            t.join(timeout=60)
        assert not t.is_alive()
    assert cl.stats["host_losses"] == 0


# --------------------------------------------------------------- router ----


def test_cluster_router_serves_through_cluster(graph):
    """``ClusterRouter`` ticks: queued updates apply as one epoch, queued
    queries go through cluster ``match_many``; every answer equals an engine
    with the same updates, and the reference router's."""
    from repro.serve.router import ClusterRouter as RefRouter

    ref_eng, (eng, fresh) = engines(graph, n_port=2, probe_impl="stacked")
    qs = queries(graph, n=4)
    rt = ClusterRouter(ClusterEngine(eng, n_hosts=2, cache_capacity=32), max_batch=2)
    ref_rt = RefRouter(RC.ClusterEngine(ref_eng, n_hosts=2, cache_capacity=32), max_batch=2)
    rng = np.random.default_rng(4)
    ups = [rand_update(rng, port_graph(graph)) for _ in range(2)]
    for (ru, pu) in ups:
        rt.submit_update(pu)
        ref_rt.submit_update(ru)
    rids = [rt.submit(q) for q in qs]
    ref_rids = [ref_rt.submit(q) for q in qs]
    rt.run_until_drained()
    ref_rt.run_until_drained()
    fresh.apply_updates([pu for _, pu in ups])
    got = [rt.finished[r] for r in rids]
    assert got == fresh.match_many(qs) == [ref_rt.finished[r] for r in ref_rids]
    st = rt.stats()
    assert st["n_finished"] == len(qs) and st["placement"]["balanced"]
    assert st["placement"] == ref_rt.stats()["placement"]
    from repro_torch.serve import QueueFull

    small = ClusterRouter(rt.cluster, max_queue=1)
    small.submit(qs[0])
    with pytest.raises(QueueFull):
        small.submit(qs[1])
    rt.close()


def test_init_distributed_local_mode_and_durability_raises(graph):
    """One process is local mode, with no group; ``durability=`` names
    ROADMAP item 16."""
    assert init_distributed(num_processes=1) == {"mode": "local", "num_processes": 1,
                                                 "process_id": 0}
    assert init_distributed(num_processes=2, process_id=1)["mode"] == "local"  # no address
    assert not torch.distributed.is_initialized()
    eng = port_engine(graph)
    with pytest.raises(NotImplementedError, match="item 16"):
        ClusterEngine(eng, n_hosts=2, durability="somewhere")


# ------------------------------------------------------ two processes ----

_COMMON = """
import sys
import numpy as np
from repro_torch.core import GnnPeConfig, GnnPeEngine
from repro_torch.dist import (ClusterEngine, DirExchange, ExchangeHost, LocalHost,
                              init_distributed, serve_exchange_host)
from repro_torch.graphs import erdos_renyi, random_connected_query

root, coord, rank = sys.argv[1], sys.argv[2], int(sys.argv[3])
boot = init_distributed(num_processes=2, process_id=rank, coordinator_address=coord,
                        timeout_s=60.0)
g = erdos_renyi(150, avg_degree=3.5, n_labels=4, seed=5)
cfg = GnnPeConfig(n_partitions=3, encoder="monotone", n_multi=1, block_size=32,
                  group_size=4, seed=7, probe_impl="stacked")
eng = GnnPeEngine(cfg, device="cpu").build(g)
ex = DirExchange(root)
if rank == 1:
    n = serve_exchange_host(eng, 1, ex, timeout=90.0)
    print("WORKER_OK", boot["mode"], n)
else:
    qs = [random_connected_query(g, 4 + s % 3, seed=50 + s) for s in range(4)]
    cl = ClusterEngine(eng, hosts=[LocalHost(0, eng), ExchangeHost(1, ex, timeout=90.0)])
    assert cl.hosts[1].owned, "placement left the remote host idle"
    got = cl.match_many(qs)
    assert got == eng.match_many(qs), "scatter-gather != local match_many"
    assert cl.stats["host_losses"] == 0
    cl.shutdown()
    print("COORD_OK", boot["mode"], sum(len(m) for m in got))
"""


def test_two_process_cluster_smoke():
    """A coordinator and a worker process share the exchange directory and a
    gloo group; the scattered batch equals local ``match_many``.  Both run
    under a time-out."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as root:
        procs = [
            subprocess.Popen([sys.executable, "-c", textwrap.dedent(_COMMON), root,
                              f"127.0.0.1:{port}", str(rank)],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for rank in (1, 0)
        ]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=150))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    (out_w, err_w), (out_c, err_c) = outs
    assert procs[1].returncode == 0, f"coordinator failed:\n{out_c}\n{err_c}"
    assert procs[0].returncode == 0, f"worker failed:\n{out_w}\n{err_w}"
    assert "COORD_OK distributed" in out_c and "WORKER_OK distributed" in out_w
