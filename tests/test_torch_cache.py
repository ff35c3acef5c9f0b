"""The port's result cache (``serve/cache.py``, ``cache=True``), held
against the JAX package on the CPU: hits and the isomorphic remap, no
stale answer under updates, partition-scoped invalidation, a partition
with no candidates that gains matches, the ``contributing`` partitions of
both probes and of the hand-off (from its counts), and dr plans retired by
an update."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import GnnPeConfig as RefConfig  # noqa: E402
from repro.core import GnnPeEngine as RefEngine  # noqa: E402
from repro.graphs import erdos_renyi, from_edge_list  # noqa: E402
from repro.serve.cache import ResultCache as RefCache  # noqa: E402
from repro_torch.convert import partition_state_from_reference  # noqa: E402
from repro_torch.core import GnnPeConfig, GnnPeEngine, GraphUpdate, vf2_match  # noqa: E402
from repro_torch.obs import REGISTRY  # noqa: E402
from repro_torch.serve.cache import ResultCache, canonical_matches, remap_matches  # noqa: E402
from test_torch_delta import engines, port_graph, queries, rand_update  # noqa: E402


@pytest.fixture(scope="module")
def graph():
    return erdos_renyi(150, avg_degree=3.5, n_labels=4, seed=5)


def isomorphic_copy(q, seed: int):
    perm = np.random.default_rng(seed).permutation(q.n_vertices)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(q.n_vertices)
    return from_edge_list(
        q.n_vertices, [(int(inv[u]), int(inv[v])) for u, v in q.edge_array()], q.labels[perm]
    )


def test_hits_and_isomorphic_remap(graph):
    """A repeat hits; a relabeled-isomorphic query hits and gets its own
    vertex order; a hit's stats carry the plan in the query's ids.  The
    counts equal the reference's and land on the registry's counters."""
    ref, (eng,) = engines(graph, cache=True)
    q = queries(graph)[0]
    q_iso = isomorphic_copy(q, 3)
    hits = REGISTRY.counter("gnnpe_result_cache_lookups_total", labels=("result",))
    events = REGISTRY.counter("gnnpe_cache_events_total", labels=("event",))
    before = (hits.get(result="hit"), events.get(event="insertions"))
    got = [eng.match(x) for x in (q, q, q_iso)]
    want = [ref.match(x) for x in (q, q, q_iso)]
    assert got == want and got[0] == got[1] and got[0]
    st = eng._result_cache.stats
    assert (st.hits, st.misses, st.insertions) == (2, 1, 1)
    assert st.as_dict() == ref._result_cache.stats.as_dict()
    after = (hits.get(result="hit"), events.get(event="insertions"))
    assert after == (before[0] + 2, before[1] + 1)
    assert set(got[2]) == set(vf2_match(port_graph(graph), q_iso))
    _, stats = eng.match(q, return_stats=True)
    assert stats.cache_hit and stats.n_matches == len(got[0])
    assert {v for p in stats.plan.paths for v in p} == set(range(q.n_vertices))
    arr = canonical_matches(got[0], np.arange(q.n_vertices)[::-1], q.n_vertices)
    assert remap_matches(arr, np.arange(q.n_vertices)[::-1]) == got[0]


@pytest.mark.parametrize("probe", ["loop", "stacked"])
def test_never_stale_under_updates(graph, probe):
    """Serve, update, serve: every answer equals VF2's on the live graph and
    the reference's list, and repeats within an epoch hit as the
    reference's do."""
    ref, (eng,) = engines(graph, cache=True, delta_compact_min=10**9, probe_impl=probe)
    rng = np.random.default_rng(11)
    qs = queries(graph)
    for epoch in range(3):
        for q in qs + qs:
            got = eng.match(q)
            assert got == ref.match(q)
            assert set(got) == set(vf2_match(eng.graph, q)), f"stale at epoch {epoch}"
        ru, pu = rand_update(rng, eng.graph, add=3, remove=3)
        ref.apply_updates(ru)
        eng.apply_updates(pu)
        assert len(eng._result_cache) == len(ref._result_cache)
    assert eng._result_cache.stats.hits >= 3
    assert eng._result_cache.stats.as_dict() == ref._result_cache.stats.as_dict()


def test_partition_scoped_invalidation_and_lru():
    """The unit contract, step by step beside the reference's cache."""
    m = np.zeros((1, 3), np.int32)
    for cache in (ResultCache(capacity=8), RefCache(capacity=8)):
        cache.put(b"a", m, contributing={0}, plan_hashes={101}, epoch=0)
        cache.put(b"b", m, contributing={1}, plan_hashes={202}, epoch=0)
        # a deletion in partition 0 evicts only its contributor
        deleted = {0: {"deleted": True, "inserted_hashes": np.zeros(0, np.int64)}}
        assert cache.invalidate(deleted) == 1
        assert cache.get(b"a") is None and cache.get(b"b") is not None
        # an insertion into a partition that did not contribute evicts only
        # the entries whose plan-path hashes it meets
        cache.put(b"c", m, contributing={1}, plan_hashes={303}, epoch=1)
        cache.invalidate({2: {"deleted": False, "inserted_hashes": np.asarray([303])}})
        assert cache.get(b"c") is None and cache.get(b"b") is not None
        assert cache.invalidate({}) == 0
    small = [ResultCache(capacity=2), RefCache(capacity=2)]
    for cache in small:
        for i, key in enumerate([b"x", b"y", b"z"]):
            cache.put(key, m, contributing={0}, plan_hashes={i}, epoch=0)
        assert cache.get(b"x") is None and cache.get(b"z") is not None
        cache.clear()
        assert len(cache) == 0
    assert small[0].stats.as_dict() == small[1].stats.as_dict()
    assert small[0].stats.evicted == 1
    with pytest.raises(ValueError, match="capacity"):
        ResultCache(capacity=0)


def test_partition_without_candidates_gains_matches():
    """A cached EMPTY result is dropped when an update inserts label-matching
    paths into a partition that gave no candidates."""
    n = 40
    labels = np.zeros(n, np.int32)
    labels[n - 1] = 1  # keeps label 1 in the vocabulary without a 1-1-1 chain
    g = from_edge_list(n, [(i, i + 1) for i in range(n - 1)], labels)
    cfg = dict(n_partitions=2, encoder="monotone", n_multi=0, block_size=32, cache=True,
               delta_compact_min=10**9)
    ref = RefEngine(RefConfig(**cfg)).build(g)
    eng = GnnPeEngine(GnnPeConfig(**cfg), device="cpu").build(
        port_graph(g), params=partition_state_from_reference(ref.models)
    )
    q = from_edge_list(3, [(0, 1), (1, 2)], np.array([1, 1, 1], np.int32))
    assert eng.match(q) == [] and eng.match(q) == []
    assert eng._result_cache.stats.hits == 1
    upd = GraphUpdate(
        add_vertex_labels=np.array([1, 1, 1], np.int32),
        add_edges=np.array([[n, n + 1], [n + 1, n + 2], [0, n]]),
    )
    s = eng.apply_updates(upd)
    assert s["mutated"] and eng._result_cache.stats.invalidated == 1
    got = eng.match(q)
    assert got and set(got) == set(vf2_match(eng.graph, q))


def test_contributing_partitions_equal_reference(graph):
    """``_match_many_core``'s contributing partitions, the cache's scope,
    under pending buffers and tombstones: the reference's for both probes
    (from the memo) and for the hand-off (from its counts)."""
    ref, (eng,) = engines(graph, n_partitions=5, delta_compact_min=10**9)
    rng = np.random.default_rng(8)
    for _ in range(2):
        ru, pu = rand_update(rng, eng.graph, add=4, remove=4)
        ref.apply_updates(ru)
        eng.apply_updates(pu)
    qs = queries(graph, n=4)
    for probe, join in (("loop", "numpy"), ("stacked", "numpy"), ("stacked", "device")):
        got = eng._match_many_core(qs, "path", probe, join)
        want = ref._match_many_core(qs, "path", probe, join)
        assert got[0] == want[0]
        assert got[2] == want[2], (probe, join)
    assert any(len(c) > 1 for c in got[2])


def test_dr_plans_retire_on_update(graph):
    """A dr plan is cached under the index fingerprint; a mutating epoch
    bumps the fingerprint as the reference's does, the plan retires, and
    the new plan's matches are exact."""
    ref, (eng,) = engines(graph, n_partitions=2, n_multi=0, plan_weight="dr")
    q = queries(graph)[0]
    assert eng.match(q) == ref.match(q)
    fp = eng._emb_fingerprint
    plan = eng._dr_plan_peek(q, 1)
    assert plan is not None and plan.paths == ref._dr_plan_peek(q, 1).paths
    assert eng.match(q) == eng.match(q, impl="scalar")
    e = eng.graph.edge_array()
    eng.apply_updates(GraphUpdate(remove_edges=e[:1]))
    assert eng._emb_fingerprint != fp and eng._dr_plan_peek(q, 1) is None
    assert set(eng.match(q)) == set(vf2_match(eng.graph, q))
    # a no-op epoch keeps the fingerprint and the plan
    fp = eng._emb_fingerprint
    eng.apply_updates(GraphUpdate())
    assert eng._emb_fingerprint == fp and eng._dr_plan_peek(q, 1) is not None
    # a rebuild epoch retires it too
    eng.apply_updates(GraphUpdate(), strategy="rebuild")
    assert eng._emb_fingerprint != fp and eng._dr_plan_peek(q, 1) is None
