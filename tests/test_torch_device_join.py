"""The device join (``join_impl="device"``) on the CPU: the port's batched
sort-merge join gives the JAX package's device-join tables, counts and
columns, and its ``match_from_candidates`` / ``match_from_candidates_many``
/ ``GnnPeEngine.match_many`` give the reference's device-join match lists,
identical, on the same candidates and weights.  Match sets equal VF2's and
the host-order join's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import GnnPeConfig as RefConfig  # noqa: E402
from repro.core import GnnPeEngine as RefEngine  # noqa: E402
from repro.core import matcher as RM  # noqa: E402
from repro.core.paths import enumerate_paths  # noqa: E402
from repro.core.planner import plan_query  # noqa: E402
from repro.graphs import (  # noqa: E402
    from_edge_list,
    newman_watts_strogatz,
    random_connected_query,
)
from repro_torch.convert import partition_state_from_reference  # noqa: E402
from repro_torch.core import (  # noqa: E402
    GnnPeConfig,
    GnnPeEngine,
    canonical_form,
    sort_matches,
    vf2_match,
)
from repro_torch.core import matcher as PM  # noqa: E402
from repro_torch.graphs import Graph, device_graph  # noqa: E402

CPU = torch.device("cpu")


def port(g) -> Graph:
    return Graph(g.offsets, g.nbrs, g.labels)


def label_candidates(g, q, paths, allp):
    """Every data path whose labels match the query path's (the join's
    heaviest input: no dominance pruning)."""
    out = []
    for p in paths:
        lab = q.labels[np.asarray(p)]
        out.append(allp[np.all(g.labels[allp] == lab[None, :], axis=1)].astype(np.int32))
    return out


def iso_copies(q, n: int, seed: int):
    """``q`` and n − 1 vertex-relabeled isomorphic copies."""
    rng = np.random.default_rng(seed)
    out = [q]
    e = q.edge_array()
    for _ in range(n - 1):
        perm = rng.permutation(q.n_vertices)
        labs = np.empty(q.n_vertices, np.int64)
        labs[perm] = q.labels
        out.append(from_edge_list(q.n_vertices, np.stack([perm[e[:, 0]], perm[e[:, 1]]], 1), labs))
    return out


@pytest.fixture(scope="module")
def nws():
    g = newman_watts_strogatz(240, k=4, p=0.1, n_labels=5, seed=0)
    allp = enumerate_paths(g, np.arange(g.n_vertices, dtype=np.int32), 2)
    return g, allp


@pytest.fixture(scope="module")
def hub_graph():
    """An NWS graph plus a hub of degree > 64: the refine's CSR layout."""
    g0 = newman_watts_strogatz(200, k=4, p=0.1, n_labels=4, seed=4)
    e = g0.edge_array()
    hub = np.stack([np.zeros(90, np.int64), np.arange(100, 190)], 1)
    g = from_edge_list(g0.n_vertices, np.concatenate([e, hub]), g0.labels)
    assert int(g.degrees.max()) > PM._DENSE_ADJ_MAX_DEG
    allp = enumerate_paths(g, np.arange(g.n_vertices, dtype=np.int32), 2)
    return g, allp


def _assert_tables_equal(plan_paths, cands, n_values, assume_unique):
    want_t, want_c, want_cols = RM._join_candidates_device(
        plan_paths, cands, n_values, assume_unique=assume_unique
    )
    got_t, got_c, got_cols = PM._join_candidates_device(
        plan_paths, cands, n_values, CPU, assume_unique=assume_unique
    )
    assert got_cols == want_cols and got_c == want_c
    assert got_t.dtype == torch.int32
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    return got_c


@pytest.mark.parametrize("assume_unique", [False, True])
def test_join_tables_equal_reference_shared_columns(nws, assume_unique):
    g, allp = nws
    rng = np.random.default_rng(1)
    counts = []
    for qi in range(4):
        q = random_connected_query(g, int(rng.choice([4, 5, 6])), seed=qi)
        plan = plan_query(q, 2)
        cands = label_candidates(g, q, plan.paths, allp)
        if not assume_unique:  # the general contract: duplicate rows
            cands = [np.concatenate([c, c[: c.shape[0] // 2]]) for c in cands]
        counts.append(_assert_tables_equal(plan.paths, cands, g.n_vertices, assume_unique))
    assert sum(counts) > 0


@pytest.mark.parametrize("assume_unique", [False, True])
def test_join_tables_equal_reference_cartesian(assume_unique):
    g = newman_watts_strogatz(120, k=4, p=0.1, n_labels=3, seed=2)
    e = g.edge_array()
    edges_dir = np.concatenate([e, e[:, ::-1]], axis=0)
    labs = [g.labels[e[3, 0]], g.labels[e[3, 1]], g.labels[e[40, 0]], g.labels[e[40, 1]]]
    plan_paths = [(0, 1), (2, 3)]  # no shared query vertex: cartesian join
    cands = []
    for p in plan_paths:
        m = (g.labels[edges_dir[:, 0]] == labs[p[0]]) & (g.labels[edges_dir[:, 1]] == labs[p[1]])
        cands.append(edges_dir[m].astype(np.int32))
    assert _assert_tables_equal(plan_paths, cands, g.n_vertices, assume_unique) > 0


def test_join_zero_pair_step_is_empty():
    """A step whose keys match nothing ends the join empty, with every
    column named, as in the reference."""
    g = newman_watts_strogatz(80, k=4, p=0.1, n_labels=2, seed=0)
    plan_paths = [(0, 1), (0, 2)]
    cands = [np.asarray([[1, 2], [3, 4]], np.int32), np.asarray([[5, 6]], np.int32)]
    assert _assert_tables_equal(plan_paths, cands, g.n_vertices, False) == 0
    q = from_edge_list(3, np.asarray([[0, 1], [0, 2]]), np.zeros(3, np.int64))
    pg = port(g)
    assert PM.match_from_candidates(
        pg, device_graph(pg, CPU), q, plan_paths, cands, join_impl="device"
    ) == []


@pytest.mark.parametrize("graph", ["nws", "hub_graph"])
@pytest.mark.parametrize("induced", [False, True])
def test_match_lists_equal_reference(request, graph, induced):
    """Single-query and batched entry points, dense and CSR refine."""
    g, allp = request.getfixturevalue(graph)
    pg = port(g)
    dg = device_graph(pg, CPU)
    rng = np.random.default_rng(3)
    qs = [random_connected_query(g, int(rng.choice([4, 5])), seed=10 + s) for s in range(4)]
    plans = [plan_query(q, 2).paths for q in qs]
    cands = [label_candidates(g, q, pp, allp) for q, pp in zip(qs, plans)]
    for q, pp, cl in zip(qs, plans, cands):
        want = RM.match_from_candidates(g, q, pp, cl, induced=induced, join_impl="device")
        got = PM.match_from_candidates(pg, dg, q, pp, cl, induced=induced, join_impl="device")
        assert got == want
        assert sort_matches(got) == sort_matches(vf2_match(pg, q, induced=induced))
    want = RM.match_from_candidates_many(
        g, qs, plans, cands, induced=induced, join_impl="device", assume_unique=True
    )
    got = PM.match_from_candidates_many(
        pg, dg, qs, plans, [[torch.from_numpy(c) for c in cl] for cl in cands],
        induced=induced, join_impl="device", assume_unique=True,
    )
    assert got == want and sum(map(len, got)) > 0


def test_isomorphic_queries_form_one_group(nws, monkeypatch):
    g, allp = nws
    pg = port(g)
    qs = iso_copies(random_connected_query(g, 5, seed=42), 4, seed=9)
    # one plan in canonical vertex space, mapped to each member (as the
    # engine's plan cache does)
    perm0, _ = canonical_form(qs[0])
    inv0 = np.argsort(perm0)
    plan0 = plan_query(qs[0], 2).paths
    plans = []
    for q in qs:
        perm, _ = canonical_form(q)
        plans.append([tuple(int(perm[inv0[v]]) for v in p) for p in plan0])
    cands = [label_candidates(g, q, pp, allp) for q, pp in zip(qs, plans)]
    want = RM.match_from_candidates_many(
        g, qs, plans, cands, join_impl="device", assume_unique=True
    )
    sizes = []
    batch = PM._join_candidates_device_batch

    def counted(plan_paths, groups, *a, **k):
        sizes.append(len(groups))
        return batch(plan_paths, groups, *a, **k)

    monkeypatch.setattr(PM, "_join_candidates_device_batch", counted)
    got = PM.match_from_candidates_many(
        pg, device_graph(pg, CPU), qs, plans, cands, join_impl="device", assume_unique=True
    )
    assert sizes == [4], "relabeled-isomorphic queries must join as one group"
    assert got == want
    canon = {tuple(sorted(m)) for m in got[0]}
    assert canon and all({tuple(sorted(m)) for m in ms} == canon for ms in got[1:])


CFG = dict(n_partitions=3, theta=10, n_multi=2, encoder="monotone", seed=0)


@pytest.fixture(scope="module")
def engines():
    g = newman_watts_strogatz(160, k=4, p=0.15, n_labels=4, seed=7)
    ref = RefEngine(RefConfig(**CFG)).build(g)
    state = partition_state_from_reference(ref.models)
    eng = GnnPeEngine(GnnPeConfig(**CFG), device="cpu").build(port(g), params=state)
    base = random_connected_query(g, 5, seed=3)
    qs = [random_connected_query(g, 5 + s % 2, seed=20 + s) for s in range(4)]
    return g, ref, eng, qs + iso_copies(base, 3, seed=1)


def test_engine_device_join_equals_reference(engines):
    g, ref, eng, qs = engines
    got, stats = eng.match_many(qs, join_impl="device", return_stats=True)
    assert got == ref.match_many(qs, join_impl="device")
    assert sum(map(len, got)) > 0
    assert all(st.n_matches == len(m) and st.join_time > 0 for st, m in zip(stats, got))
    assert eng.match(qs[0], join_impl="device") == got[0]


def test_engine_device_and_host_joins_agree(engines):
    g, _, eng, qs = engines
    dev = eng.match_many(qs, join_impl="device")
    host = eng.match_many(qs)
    for q, a, b in zip(qs, dev, host):
        assert sort_matches(a) == sort_matches(b) == sort_matches(vf2_match(port(g), q))


def test_own_weights_device_join_matches_vf2():
    g = newman_watts_strogatz(150, k=4, p=0.15, n_labels=5, seed=11)
    cfg = GnnPeConfig(n_partitions=2, n_multi=1, encoder="monotone", seed=5, join_impl="device")
    eng = GnnPeEngine(cfg, device="cpu").build(port(g))
    qs = [random_connected_query(g, 5, seed=500 + s) for s in range(4)]
    for q, m in zip(qs, eng.match_many(qs)):
        assert set(m) == set(vf2_match(port(g), q)) and len(m) == len(set(m))


def test_join_impl_override_is_checked(engines):
    _, _, eng, qs = engines
    with pytest.raises(ValueError, match="join_impl"):
        eng.match_many(qs, join_impl="bogus")
    with pytest.raises(ValueError, match="join_impl"):
        GnnPeEngine(GnnPeConfig(join_impl="bogus"), device="cpu")
