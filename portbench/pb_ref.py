"""The plain reference: exact subgraph matching by backtracking.

A match of query q in data graph G is an injective map f of q's vertices
to G's with L(f(u)) = L(u) for every vertex and (f(u), f(v)) an edge of G
for every edge (u, v) of q (non-induced subgraph isomorphism, the
semantics of the program's default ``induced=False``).  A match is the
tuple (f(0), ..., f(|V(q)| - 1)).

Plain Python over adjacency sets, written from that definition alone:
it takes the data graph and the queries as the benchmark made them, and
nothing that the program built (no index, plan or embedding).  It
imports nothing of the program.
"""
from __future__ import annotations

import numpy as np

from pb_gen import DataGraph, Query

__all__ = ["Reference", "spanning_tree"]


class Reference:
    """Matcher over one data graph (adjacency sets built once)."""

    def __init__(self, g: DataGraph) -> None:
        nbrs = g.nbrs.tolist()
        off = g.offsets.tolist()
        self.adj = [set(nbrs[off[v]: off[v + 1]]) for v in range(g.n_vertices)]
        self.labels = g.labels.tolist()
        self.deg = np.diff(g.offsets).tolist()
        order = np.argsort(g.labels, kind="stable")
        bounds = np.searchsorted(g.labels[order], np.arange(int(g.labels.max(initial=0)) + 2))
        self.by_label = [order[bounds[i]: bounds[i + 1]].tolist() for i in range(len(bounds) - 1)]

    def _count(self, label: int) -> int:
        return len(self.by_label[label]) if 0 <= label < len(self.by_label) else 0

    def _order(self, q: Query, qadj: list) -> list:
        """Rarest label (then highest degree) first, then always the vertex
        with the most already-ordered neighbours (ties: rarer label)."""
        lab = q.labels.tolist()

        def rank(u: int) -> tuple:
            return (self._count(lab[u]), -len(qadj[u]), u)

        order = [min(range(q.n), key=rank)]
        seen = set(order)
        while len(order) < q.n:
            u = min((u for u in range(q.n) if u not in seen),
                    key=lambda u: (-len(qadj[u] & seen),) + rank(u))
            order.append(u)
            seen.add(u)
        return order

    def match(self, q: Query) -> list:
        """Every match of ``q``, as a list of tuples, each once."""
        qadj = [set() for _ in range(q.n)]
        for u, v in q.edges.tolist():
            qadj[u].add(v)
            qadj[v].add(u)
        order = self._order(q, qadj)
        pos = {u: i for i, u in enumerate(order)}
        back = [[w for w in qadj[u] if pos[w] < pos[u]] for u in order]
        lab = q.labels.tolist()
        need = [len(qadj[u]) for u in order]
        adj, labels, deg = self.adj, self.labels, self.deg
        f = [-1] * q.n
        used: set = set()
        out: list = []

        def extend(i: int) -> None:
            if i == q.n:
                out.append(tuple(f))
                return
            u = order[i]
            if back[i]:
                sets = sorted((adj[f[w]] for w in back[i]), key=len)
                cand = sets[0].intersection(*sets[1:]) if len(sets) > 1 else sets[0]
            else:
                cand = self.by_label[lab[u]] if 0 <= lab[u] < len(self.by_label) else ()
            for v in cand:
                if labels[v] != lab[u] or v in used or deg[v] < need[i]:
                    continue
                f[u] = v
                used.add(v)
                extend(i + 1)
                used.discard(v)
            f[u] = -1

        extend(0)
        return out


def spanning_tree(q: Query) -> Query:
    """``q`` with only the edges of a breadth-first spanning tree from
    vertex 0: the query that a matcher which never checks the remaining
    (non-tree) edges answers."""
    adj = [[] for _ in range(q.n)]
    for u, v in q.edges.tolist():
        adj[u].append(v)
        adj[v].append(u)
    seen, frontier, tree = {0}, [0], []
    while frontier:
        nxt = []
        for u in frontier:
            for v in sorted(adj[u]):
                if v not in seen:
                    seen.add(v)
                    nxt.append(v)
                    tree.append((min(u, v), max(u, v)))
        frontier = nxt
    e = np.asarray(sorted(tree), np.int64).reshape(-1, 2)
    return Query(q.n, e, q.labels)
