"""Inputs of a run, made from seeds: the data graph and the query pool.

Frozen NumPy copies of the paper's generators (GNN-PE §6.1): a
Newman–Watts–Strogatz small-world graph with uniform labels, and
connected query graphs sampled from it by random expansion, induced,
optionally thinned to an average degree.  They follow the program's
``graphs.newman_watts_strogatz`` and ``graphs.random_connected_query``
step for step, but live here so that a change to the program cannot
change the benchmark's inputs.  Nothing here imports the program.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DataGraph", "Query", "rng_for", "csr", "nws_graph", "sample_query", "query_pool"]

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class DataGraph:
    """Undirected labeled graph: sorted CSR rows, no self loops."""

    offsets: np.ndarray  # (n + 1,) int64
    nbrs: np.ndarray  # (2|E|,) int64
    labels: np.ndarray  # (n,) int64

    @property
    def n_vertices(self) -> int:
        return int(self.labels.shape[0])

    def neighbors(self, v: int) -> np.ndarray:
        return self.nbrs[self.offsets[v]: self.offsets[v + 1]]

    def edges(self) -> np.ndarray:
        """(|E|, 2) int64, u < v, in CSR order."""
        src = np.repeat(np.arange(self.n_vertices, dtype=np.int64), np.diff(self.offsets))
        keep = src < self.nbrs
        return np.stack([src[keep], self.nbrs[keep]], axis=1)


@dataclasses.dataclass(frozen=True)
class Query:
    """A query graph: ``n`` vertices, (m, 2) int64 edges u < v, labels."""

    n: int
    edges: np.ndarray
    labels: np.ndarray


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one named stream of a run's seed (any int)."""
    return np.random.default_rng(np.random.SeedSequence([seed & _MASK64, *stream]))


def csr(n: int, edges: np.ndarray, labels: np.ndarray) -> DataGraph:
    """CSR of an undirected edge list: self loops and repeats dropped."""
    e = np.asarray(edges, np.int64).reshape(-1, 2)
    e = e[e[:, 0] != e[:, 1]]
    both = np.concatenate([e, e[:, ::-1]])
    key = np.unique(both[:, 0] * n + both[:, 1])
    src, dst = key // n, key % n
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=offsets[1:])
    return DataGraph(offsets, dst, np.asarray(labels, np.int64))


def nws_graph(n: int, k: int, p: float, n_labels: int, rng: np.random.Generator) -> DataGraph:
    """Ring lattice of ``k`` nearest neighbours plus Binomial(nk/2, p)
    uniform shortcuts (Newman–Watts: the ring is kept, so connected),
    labels uniform over ``n_labels``."""
    half = max(k // 2, 1)
    src = np.repeat(np.arange(n, dtype=np.int64), half)
    dst = (src + np.tile(np.arange(1, half + 1, dtype=np.int64), n)) % n
    n_short = rng.binomial(src.shape[0], p)
    short = rng.integers(0, n, size=(2, n_short))
    edges = np.concatenate([np.stack([src, dst], 1), short.T])
    return csr(n, edges, rng.integers(0, n_labels, size=n))


def _thin(n: int, edges: np.ndarray, avg_degree: float, rng: np.random.Generator) -> np.ndarray:
    """A random spanning tree of the query plus random extra edges, up to
    round(avg_degree · n / 2) edges (never fewer than n − 1)."""
    target = max(n - 1, int(round(avg_degree * n / 2.0)))
    if edges.shape[0] <= target:
        return edges
    parent = list(range(n))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    keep, extra = [], []
    for i in rng.permutation(edges.shape[0]):
        ru, rv = find(int(edges[i, 0])), find(int(edges[i, 1]))
        if ru != rv:
            parent[ru] = rv
            keep.append(i)
        else:
            extra.append(i)
    keep += extra[: target - len(keep)]
    return edges[np.sort(np.asarray(keep, np.int64))]


def sample_query(g: DataGraph, size: int, rng: np.random.Generator,
                 avg_degree: float | None = None) -> Query:
    """A connected ``size``-vertex query: grow a vertex set from a uniform
    start by uniform picks from its frontier, take the induced subgraph
    (vertices renumbered in increasing id), then thin it to
    ``avg_degree`` where given."""
    for _ in range(64):
        start = int(rng.integers(0, g.n_vertices))
        chosen = [start]
        frontier = set(map(int, g.neighbors(start)))
        while len(chosen) < size and frontier:
            nxt = int(rng.choice(sorted(frontier)))
            chosen.append(nxt)
            frontier |= set(map(int, g.neighbors(nxt)))
            frontier -= set(chosen)
        if len(chosen) < size:
            continue
        vs = np.asarray(sorted(chosen), np.int64)
        local = {int(v): i for i, v in enumerate(vs)}
        edges = [(local[int(v)], local[int(w)]) for v in vs for w in g.neighbors(int(v))
                 if int(w) in local and int(v) < int(w)]
        e = np.asarray(edges, np.int64).reshape(-1, 2)
        e = e[np.lexsort((e[:, 1], e[:, 0]))]
        if avg_degree is not None and 2.0 * e.shape[0] / size > avg_degree:
            e = _thin(size, e, avg_degree, rng)
        if e.shape[0]:
            return Query(size, e, g.labels[vs].copy())
    raise RuntimeError("could not sample a connected query graph")


def query_pool(g: DataGraph, n: int, size: int, avg_degree: float | None,
               rng: np.random.Generator) -> list:
    """``n`` queries drawn in turn from one generator."""
    return [sample_query(g, size, rng, avg_degree) for _ in range(n)]
