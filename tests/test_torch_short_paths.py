"""Queries with no simple path of ``path_length`` edges (the port's repair of
a fault the JAX package shares), on the CPU.

Such a query plans over shorter paths, which no index holds; the port takes
their candidates from the live graph (``GnnPeEngine._short_path_candidates``).
Held here:

- single-edge queries at l = 2, and 2- and 3-vertex queries and a 7-edge
  star at l = 3, give ``vf2_match``'s set through the scalar match, both
  probes × both joins (the stacked probe's hand-off included) and
  ``ClusterEngine``, before and after live updates (with the result cache
  on), and as standing queries;
- queries of 3 or more vertices at l = 2 still give the JAX package's lists,
  order included, through every probe and join.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import GnnPeConfig as RefConfig  # noqa: E402
from repro.core import GnnPeEngine as RefEngine  # noqa: E402
from repro.graphs import erdos_renyi, random_connected_query  # noqa: E402
from repro_torch.convert import partition_state_from_reference  # noqa: E402
from repro_torch.core import GnnPeConfig, GnnPeEngine, GraphUpdate, vf2_match  # noqa: E402
from repro_torch.dist import ClusterEngine  # noqa: E402
from repro_torch.graphs import Graph, from_edge_list  # noqa: E402

BASE = dict(n_partitions=3, encoder="monotone", n_multi=1, block_size=32, group_size=4)
ROUTES = [("loop", "numpy"), ("loop", "device"), ("stacked", "numpy"), ("stacked", "device")]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: test files run in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_graph():
    return erdos_renyi(120, avg_degree=3.5, n_labels=4, seed=5)


@pytest.fixture(scope="module")
def graph(ref_graph):
    return Graph(ref_graph.offsets, ref_graph.nbrs, ref_graph.labels)


def edge_query(a: int, b: int) -> Graph:
    return from_edge_list(2, [(0, 1)], np.array([a, b], np.int32))


def star_query(g: Graph, leaves: int) -> Graph:
    """A star with ``leaves`` edges around the graph's highest-degree vertex,
    labelled as it and its first neighbours are, so at least one match exists."""
    c = int(np.argmax(g.degrees))
    nb = [int(v) for v in g.neighbors(c)][:leaves]
    assert len(nb) == leaves
    labels = np.array([g.labels[c]] + [g.labels[v] for v in nb], np.int32)
    return from_edge_list(leaves + 1, [(0, i + 1) for i in range(leaves)], labels)


def short_queries(g: Graph, length: int) -> list:
    qs = [edge_query(0, 1), edge_query(2, 2), edge_query(3, 0)]
    if length == 3:
        qs += [
            from_edge_list(3, [(0, 1), (1, 2)], np.array([0, 1, 0], np.int32)),
            from_edge_list(3, [(0, 1), (1, 2), (0, 2)], np.array([1, 2, 3], np.int32)),
            star_query(g, 7),
        ]
    return qs


def port_engine(g: Graph, **fields) -> GnnPeEngine:
    return GnnPeEngine(GnnPeConfig(**{**BASE, **fields}), device="cpu").build(g)


def assert_vf2(g: Graph, q: Graph, got: list, where: str) -> None:
    want = sorted(vf2_match(g, q))
    assert want, f"{where}: a query with no match tells nothing"
    assert sorted(got) == want, f"{where}: {len(got)} matches, VF2 {len(want)}"


@pytest.mark.parametrize("length", [2, 3])
@pytest.mark.parametrize("kind", ["path", "grouped"])
def test_short_queries_equal_vf2_on_every_route(graph, length, kind):
    eng = port_engine(graph, path_length=length, index_kind=kind)
    qs = short_queries(graph, length)
    for qi, q in enumerate(qs):
        plan_lens = {len(p) for p in eng._deg_plan_cached(q).paths}
        assert max(plan_lens) <= length, "the query should plan over shorter paths"
        assert_vf2(graph, q, eng.match(q, impl="scalar"), f"scalar q{qi}")
    for probe, join in ROUTES:
        got = eng.match_many(qs, probe_impl=probe, join_impl=join)
        for qi, q in enumerate(qs):
            assert_vf2(graph, q, got[qi], f"{probe}/{join} q{qi}")
    cl = ClusterEngine(eng, n_hosts=2)
    for qi, (q, got) in enumerate(zip(qs, cl.match_many(qs))):
        assert_vf2(graph, q, got, f"cluster q{qi}")
    assert cl.match_many(qs) == eng.match_many(qs)


@pytest.mark.parametrize("probe,join", ROUTES)
def test_short_queries_after_updates_and_cache(graph, probe, join):
    """The live graph's added and removed edges and vertices apply; the
    result cache never serves a stale short-path answer."""
    eng = port_engine(graph, path_length=3, probe_impl=probe, join_impl=join, cache=True,
                      delta_compact_min=10**6)  # the buffers and tombstones stay live
    qs = short_queries(graph, 3)
    eng.match_many(qs)  # a cache entry would be stale after the edits
    rng = np.random.default_rng(7)
    for _ in range(3):
        g = eng.graph
        e = g.edge_array()
        eng.apply_updates(GraphUpdate.from_arrays({
            "add_edges": rng.integers(0, g.n_vertices, size=(6, 2)),
            "remove_edges": e[rng.choice(e.shape[0], size=4, replace=False)],
            "add_vertex_labels": np.array([1], np.int32),
            "remove_vertices": rng.integers(0, g.n_vertices, size=1),
        }))
        got = eng.match_many(qs)
        for qi, q in enumerate(qs):
            assert_vf2(eng.graph, q, got[qi], f"epoch {eng.epoch} q{qi}")
            assert_vf2(eng.graph, q, eng.match(q, impl="scalar"), f"scalar epoch {eng.epoch}")
    st = eng.delta.stats()
    assert st["tombstones"] > 0 and st["delta_rows"] > 0


def test_short_standing_queries_follow_the_stream(graph):
    eng = port_engine(graph, path_length=2)
    qs = short_queries(graph, 2)
    states = []
    for q in qs:
        st, delta = eng.match_incremental(q)
        assert sorted(delta.added) == sorted(vf2_match(eng.graph, q))
        states.append([st, set(delta.added)])
    rng = np.random.default_rng(3)
    for _ in range(3):
        g = eng.graph
        e = g.edge_array()
        eng.apply_updates(GraphUpdate.from_arrays({
            "add_edges": rng.integers(0, g.n_vertices, size=(5, 2)),
            "remove_edges": e[rng.choice(e.shape[0], size=5, replace=False)],
            "add_vertex_labels": np.zeros(0, np.int32),
            "remove_vertices": np.zeros(0, np.int64),
        }))
        for (q, ent) in zip(qs, states):
            ent[0], delta = eng.match_incremental(q, ent[0])
            ent[1] = (ent[1] - set(delta.retracted)) | set(delta.added)
            assert ent[1] == set(vf2_match(eng.graph, q))
            assert ent[0].last_work == "full"


@pytest.mark.parametrize("kind", ["path", "grouped"])
def test_long_queries_keep_the_reference_lists(ref_graph, graph, kind):
    ref = RefEngine(RefConfig(**BASE, index_kind=kind)).build(ref_graph)
    eng = GnnPeEngine(GnnPeConfig(**BASE, index_kind=kind), device="cpu").build(
        graph, params=partition_state_from_reference(ref.models))
    qs = [random_connected_query(ref_graph, 3 + s % 4, seed=20 + s) for s in range(5)]
    for probe, join in ROUTES:
        want = ref.match_many(qs, probe_impl=probe, join_impl=join)
        assert sum(map(len, want)) > 0
        assert eng.match_many(qs, probe_impl=probe, join_impl=join) == want, (probe, join)
    assert [eng.match(q, impl="scalar") for q in qs] == [ref.match(q, impl="scalar") for q in qs]
