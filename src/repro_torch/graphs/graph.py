"""Undirected labeled graph in CSR form (Definition 1 of the paper).

Graphs are flat numpy arrays on the host, so the generators give the
same arrays for the same seed as the JAX package's ``repro.graphs``.
``DeviceGraph`` mirrors the CSR arrays as int64 tensors on one device
for the stages that run there (stars, paths, refine).  Vertices are
``0..n-1``; labels are small ints in ``[0, n_labels)``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np
import torch

__all__ = [
    "Graph",
    "DeviceGraph",
    "device_graph",
    "from_edge_list",
    "newman_watts_strogatz",
    "random_labels",
    "erdos_renyi",
    "induced_subgraph",
    "random_connected_query",
]


@dataclasses.dataclass(frozen=True)
class Graph:
    """CSR undirected labeled graph.

    offsets: (n+1,) int64 — CSR row pointers.
    nbrs:    (2|E|,) int32 — concatenated sorted neighbor lists.
    labels:  (n,) int32 — vertex labels ``L(v)``.
    """

    offsets: np.ndarray
    nbrs: np.ndarray
    labels: np.ndarray

    # ---- basic accessors -------------------------------------------------
    @property
    def n_vertices(self) -> int:
        return int(self.labels.shape[0])

    @property
    def n_edges(self) -> int:
        return int(self.nbrs.shape[0] // 2)

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.offsets).astype(np.int32)

    @property
    def avg_degree(self) -> float:
        n = max(self.n_vertices, 1)
        return float(self.nbrs.shape[0]) / n

    def neighbors(self, v: int) -> np.ndarray:
        return self.nbrs[self.offsets[v] : self.offsets[v + 1]]

    def has_edge(self, u: int, v: int) -> bool:
        row = self.neighbors(u)
        i = np.searchsorted(row, v)
        return bool(i < row.shape[0] and row[i] == v)

    def edge_array(self) -> np.ndarray:
        """(|E|, 2) array of undirected edges with u < v."""
        src = np.repeat(np.arange(self.n_vertices, dtype=np.int32), self.degrees)
        mask = src < self.nbrs
        return np.stack([src[mask], self.nbrs[mask]], axis=1)

    def adjacency_sets(self) -> list[set[int]]:
        return [set(map(int, self.neighbors(v))) for v in range(self.n_vertices)]

    def validate(self) -> None:
        assert self.offsets[0] == 0 and self.offsets[-1] == self.nbrs.shape[0]
        for v in range(self.n_vertices):
            row = self.neighbors(v)
            assert np.all(np.diff(row) > 0), f"row {v} not strictly sorted"
            assert not np.any(row == v), f"self loop at {v}"


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """A ``Graph``'s CSR arrays as int64 tensors on ``device``."""

    offsets: torch.Tensor  # (n+1,)
    nbrs: torch.Tensor  # (2|E|,)
    labels: torch.Tensor  # (n,)
    degrees: torch.Tensor  # (n,)
    n_vertices: int

    @property
    def device(self) -> torch.device:
        return self.offsets.device


def device_graph(g: Graph, device) -> DeviceGraph:
    def t(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return DeviceGraph(t(g.offsets), t(g.nbrs), t(g.labels), t(g.degrees), g.n_vertices)


def from_edge_list(
    n_vertices: int,
    edges: Iterable[tuple[int, int]] | np.ndarray,
    labels: np.ndarray,
) -> Graph:
    """Build a CSR graph from an undirected edge list (dedup + both dirs)."""
    e = np.asarray(list(edges) if not isinstance(edges, np.ndarray) else edges)
    if e.size == 0:
        e = np.zeros((0, 2), dtype=np.int64)
    e = e.astype(np.int64)
    e = e[e[:, 0] != e[:, 1]]  # drop self loops
    both = np.concatenate([e, e[:, ::-1]], axis=0)
    # dedup directed pairs
    key = both[:, 0] * n_vertices + both[:, 1]
    _, idx = np.unique(key, return_index=True)
    both = both[np.sort(idx)]
    order = np.lexsort((both[:, 1], both[:, 0]))
    both = both[order]
    counts = np.bincount(both[:, 0], minlength=n_vertices)
    offsets = np.zeros(n_vertices + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return Graph(
        offsets=offsets,
        nbrs=both[:, 1].astype(np.int32),
        labels=np.asarray(labels, dtype=np.int32),
    )


# ---- generators (paper §6.1: NWS small-world + Uniform/Gaussian/Zipf labels)


def random_labels(
    n: int,
    n_labels: int,
    dist: str = "uniform",
    seed: int = 0,
) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dist == "uniform":
        lab = rng.integers(0, n_labels, size=n)
    elif dist == "gaussian":
        raw = rng.normal(loc=n_labels / 2.0, scale=max(n_labels / 6.0, 1.0), size=n)
        lab = np.clip(np.round(raw), 0, n_labels - 1)
    elif dist == "zipf":
        # Zipf over the label domain with exponent 1.5, rejection-free.
        ranks = np.arange(1, n_labels + 1, dtype=np.float64)
        p = ranks ** -1.5
        p /= p.sum()
        lab = rng.choice(n_labels, size=n, p=p)
    else:
        raise ValueError(f"unknown label distribution: {dist}")
    return lab.astype(np.int32)


def newman_watts_strogatz(
    n: int,
    k: int = 4,
    p: float = 0.1,
    n_labels: int = 500,
    label_dist: str = "uniform",
    seed: int = 0,
) -> Graph:
    """Newman–Watts–Strogatz small-world graph (paper's synthetic generator).

    Ring lattice with k nearest neighbors plus shortcuts added w.p. ``p``
    per lattice edge (no rewiring — NWS keeps the ring, so connected).
    """
    rng = np.random.default_rng(seed)
    half = max(k // 2, 1)
    src = np.repeat(np.arange(n, dtype=np.int64), half)
    d = np.tile(np.arange(1, half + 1, dtype=np.int64), n)
    dst = (src + d) % n
    lattice = np.stack([src, dst], axis=1)
    n_short = rng.binomial(lattice.shape[0], p)
    su = rng.integers(0, n, size=n_short)
    sv = rng.integers(0, n, size=n_short)
    shortcuts = np.stack([su, sv], axis=1)
    edges = np.concatenate([lattice, shortcuts], axis=0)
    labels = random_labels(n, n_labels, label_dist, seed=seed + 1)
    return from_edge_list(n, edges, labels)


def erdos_renyi(
    n: int,
    avg_degree: float = 4.0,
    n_labels: int = 8,
    label_dist: str = "uniform",
    seed: int = 0,
) -> Graph:
    """G(n, m) random graph with the requested average degree."""
    rng = np.random.default_rng(seed)
    m = int(round(n * avg_degree / 2.0))
    u = rng.integers(0, n, size=2 * m + 8)
    v = rng.integers(0, n, size=2 * m + 8)
    keep = u != v
    edges = np.stack([u[keep], v[keep]], axis=1)[:m]
    labels = random_labels(n, n_labels, label_dist, seed=seed + 1)
    return from_edge_list(n, edges, labels)


def induced_subgraph(g: Graph, vertices: Sequence[int]) -> tuple[Graph, np.ndarray]:
    """Induced subgraph on ``vertices``; returns (subgraph, original ids)."""
    vs = np.asarray(sorted(set(int(v) for v in vertices)), dtype=np.int64)
    remap = -np.ones(g.n_vertices, dtype=np.int64)
    remap[vs] = np.arange(vs.shape[0])
    edges = []
    for new_u, u in enumerate(vs):
        for w in g.neighbors(int(u)):
            if remap[w] >= 0 and remap[w] > new_u:
                edges.append((new_u, int(remap[w])))
    return from_edge_list(vs.shape[0], edges, g.labels[vs]), vs


def random_connected_query(
    g: Graph,
    n_vertices: int,
    seed: int = 0,
    avg_degree: float | None = None,
) -> Graph:
    """Sample a connected query graph from G by random expansion (paper §6.1:
    queries are sampled connected subgraphs of the data graph)."""
    rng = np.random.default_rng(seed)
    for _attempt in range(64):
        start = int(rng.integers(0, g.n_vertices))
        chosen: list[int] = [start]
        frontier = set(map(int, g.neighbors(start)))
        while len(chosen) < n_vertices and frontier:
            nxt = int(rng.choice(sorted(frontier)))
            chosen.append(nxt)
            frontier |= set(map(int, g.neighbors(nxt)))
            frontier -= set(chosen)
        if len(chosen) == n_vertices:
            sub, _ids = induced_subgraph(g, chosen)
            if avg_degree is not None and sub.avg_degree > avg_degree:
                # drop random edges (keeping connectivity) to hit target degree
                sub = _sparsify(sub, avg_degree, rng)
            if sub.nbrs.shape[0] > 0:
                return sub
    raise RuntimeError("could not sample a connected query graph")


def _sparsify(g: Graph, avg_degree: float, rng: np.random.Generator) -> Graph:
    edges = g.edge_array()
    target_m = max(g.n_vertices - 1, int(round(avg_degree * g.n_vertices / 2.0)))
    if edges.shape[0] <= target_m:
        return g
    # keep a random spanning tree, then random extras
    perm = rng.permutation(edges.shape[0])
    parent = np.arange(g.n_vertices)

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    keep = []
    extra = []
    for i in perm:
        u, v = int(edges[i, 0]), int(edges[i, 1])
        ru, rv = find(u), find(v)
        if ru != rv:
            parent[ru] = rv
            keep.append(i)
        else:
            extra.append(i)
    need = target_m - len(keep)
    keep += extra[: max(need, 0)]
    return from_edge_list(g.n_vertices, edges[np.asarray(keep, dtype=np.int64)], g.labels)
