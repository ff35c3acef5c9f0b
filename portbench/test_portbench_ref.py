"""The plain reference against brute force, and the frozen generators."""
from __future__ import annotations

import itertools
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from pb_gen import Query, csr, nws_graph, query_pool, rng_for, sample_query  # noqa: E402
from pb_ref import Reference, spanning_tree  # noqa: E402


def brute_force(g, q: Query) -> set:
    adj = {(int(u), int(v)) for u, v in g.edges()}
    adj |= {(v, u) for u, v in adj}
    out = set()
    for f in itertools.permutations(range(g.n_vertices), q.n):
        if all(g.labels[f[u]] == q.labels[u] for u in range(q.n)) and all(
                (f[u], f[v]) in adj for u, v in q.edges.tolist()):
            out.add(f)
    return out


def random_graph(rng, n: int, m: int, n_labels: int):
    return csr(n, rng.integers(0, n, size=(m, 2)), rng.integers(0, n_labels, size=n))


@pytest.mark.parametrize("seed", range(8))
def test_reference_equals_brute_force(seed):
    rng = np.random.default_rng(seed)
    g = random_graph(rng, 8, 14, 2)
    for size in (2, 3, 4):
        q = sample_query(g, size, rng) if g.edges().shape[0] else None
        if q is None:
            continue
        got = Reference(g).match(q)
        assert len(got) == len(set(got))
        assert set(got) == brute_force(g, q)


@pytest.mark.parametrize("seed", range(4))
def test_reference_on_thinned_queries(seed):
    rng = np.random.default_rng(100 + seed)
    g = random_graph(rng, 9, 20, 2)
    q = sample_query(g, 4, rng, avg_degree=2.0)
    assert set(Reference(g).match(q)) == brute_force(g, q)


def test_spanning_tree_control_answers_more():
    # a triangle query over a path of three equal labels: no match, but its
    # spanning tree (a path) matches
    g = csr(3, np.array([[0, 1], [1, 2]]), np.zeros(3, np.int64))
    tri = Query(3, np.array([[0, 1], [0, 2], [1, 2]]), np.zeros(3, np.int64))
    assert Reference(g).match(tri) == []
    tree = spanning_tree(tri)
    assert tree.edges.shape[0] == 2 and Reference(g).match(tree)


def test_unknown_label_has_no_match():
    g = csr(3, np.array([[0, 1], [1, 2]]), np.zeros(3, np.int64))
    q = Query(2, np.array([[0, 1]]), np.array([0, 7]))
    assert Reference(g).match(q) == []


@pytest.mark.parametrize("seed", [0, 2**31 + 7, 2**40 + 3, -5])
def test_generators_repeat_for_a_seed(seed):
    a = nws_graph(500, 4, 0.1, 10, rng_for(seed, 1))
    b = nws_graph(500, 4, 0.1, 10, rng_for(seed, 1))
    assert all(np.array_equal(x, y) for x, y in ((a.offsets, b.offsets), (a.nbrs, b.nbrs),
                                                  (a.labels, b.labels)))
    qa = query_pool(a, 12, 6, None, rng_for(seed, 2))
    qb = query_pool(b, 12, 6, None, rng_for(seed, 2))
    assert all(np.array_equal(x.edges, y.edges) and np.array_equal(x.labels, y.labels)
               for x, y in zip(qa, qb))
    other = query_pool(a, 12, 6, None, rng_for(seed + 1, 2))
    assert any(not np.array_equal(x.labels, y.labels) for x, y in zip(qa, other))


def test_nws_graph_shape():
    g = nws_graph(1000, 4, 0.1, 7, rng_for(3, 1))
    e = g.edges()
    assert g.n_vertices == 1000 and (e[:, 0] < e[:, 1]).all()
    assert len({(int(u), int(v)) for u, v in e}) == e.shape[0]
    assert 2000 <= e.shape[0] <= 2000 + 400  # the ring and about 200 shortcuts
    ring = {(v, (v + d) % 1000) for v in range(1000) for d in (1, 2)}
    have = {(int(u), int(v)) for u, v in e} | {(int(v), int(u)) for u, v in e}
    assert ring <= have
    assert g.labels.min() >= 0 and g.labels.max() < 7


@pytest.mark.parametrize("size,deg", [(8, None), (5, 2.0), (6, 3.0)])
def test_queries_are_connected_samples(size, deg):
    g = nws_graph(2000, 6, 0.1, 20, rng_for(11, 1))
    ref = Reference(g)
    for q in query_pool(g, 10, size, deg, rng_for(11, 2)):
        assert q.n == size and q.labels.shape == (size,)
        e = q.edges
        assert (e[:, 0] < e[:, 1]).all() and len({tuple(x) for x in e.tolist()}) == e.shape[0]
        assert spanning_tree(q).edges.shape[0] == size - 1  # connected
        if deg is not None:
            assert e.shape[0] <= max(size - 1, round(deg * size / 2))
        assert ref.match(q)  # sampled from the graph: it occurs there
