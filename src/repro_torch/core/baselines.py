"""Exact subgraph-matching baselines (paper §6.1 comparison set).

Three representative members of the paper's baseline families, all exact:

* ``vf2_match``      — state-space backtracking with connectivity-aware
                       candidate refinement (VF2++/RI family).  Also the
                       correctness *oracle* for every GNN-PE test.
* ``quicksi_match``  — direct enumeration in a static edge order with
                       label/degree filters only (QuickSI family).
* ``gql_match``      — GraphQL-style: per-vertex candidate sets filtered by
                       label + degree + neighbor-label profile, then
                       backtracking over the filtered candidates.

All return the complete set of embeddings f: V(q) → V(G) as tuples
``(f(0), …, f(|V(q)|−1))``.  ``induced=False`` is standard subgraph
isomorphism (edge-preserving injective), matching Definition 2.
"""
from __future__ import annotations

import numpy as np

from ..graphs import Graph

__all__ = ["vf2_match", "quicksi_match", "gql_match", "match_count"]


def _query_order(q: Graph) -> list[int]:
    """Connectivity-first, high-degree-first matching order (RI-style)."""
    n = q.n_vertices
    deg = q.degrees
    order = [int(np.argmax(deg))]
    seen = set(order)
    while len(order) < n:
        best, best_key = None, None
        for v in range(n):
            if v in seen:
                continue
            conn = sum(1 for w in q.neighbors(v) if int(w) in seen)
            key = (conn, deg[v])
            if best_key is None or key > best_key:
                best, best_key = v, key
        order.append(best)
        seen.add(best)
    return order


def vf2_match(
    g: Graph,
    q: Graph,
    induced: bool = False,
    limit: int | None = None,
) -> list[tuple[int, ...]]:
    nq = q.n_vertices
    order = _query_order(q)
    g_adj = g.adjacency_sets()
    q_adj = q.adjacency_sets()
    # label index for the first (free) vertex
    by_label: dict[int, list[int]] = {}
    for v in range(g.n_vertices):
        by_label.setdefault(int(g.labels[v]), []).append(v)

    results: list[tuple[int, ...]] = []
    mapping = [-1] * nq
    used: set[int] = set()
    g_deg = g.degrees
    q_deg = q.degrees

    def candidates(pos: int):
        u = order[pos]
        back = [w for w in q_adj[u] if mapping[w] >= 0]
        if not back:
            return [v for v in by_label.get(int(q.labels[u]), []) if g_deg[v] >= q_deg[u]]
        # intersect data-neighborhoods of already-mapped query neighbors
        sets = sorted((g_adj[mapping[w]] for w in back), key=len)
        cand = set(sets[0])
        for s in sets[1:]:
            cand &= s
        lab = int(q.labels[u])
        return [v for v in cand if int(g.labels[v]) == lab and g_deg[v] >= q_deg[u]]

    def feasible(u: int, v: int) -> bool:
        for w in q_adj[u]:
            mw = mapping[w]
            if mw >= 0 and mw not in g_adj[v]:
                return False
        if induced:
            for w in range(nq):
                mw = mapping[w]
                if mw >= 0 and w not in q_adj[u] and w != u and mw in g_adj[v]:
                    return False
        return True

    def backtrack(pos: int) -> bool:
        if pos == nq:
            results.append(tuple(mapping))
            return limit is not None and len(results) >= limit
        u = order[pos]
        for v in candidates(pos):
            if v in used or not feasible(u, v):
                continue
            mapping[u] = v
            used.add(v)
            if backtrack(pos + 1):
                return True
            used.discard(v)
            mapping[u] = -1
        return False

    backtrack(0)
    return results


def quicksi_match(g: Graph, q: Graph, limit: int | None = None) -> list[tuple[int, ...]]:
    """Direct enumeration: BFS query order, label+degree filter only."""
    nq = q.n_vertices
    # BFS order from vertex 0
    order = []
    seen = set()
    stack = [0]
    while stack:
        u = stack.pop(0)
        if u in seen:
            continue
        seen.add(u)
        order.append(u)
        stack.extend(int(w) for w in q.neighbors(u) if int(w) not in seen)
    for v in range(nq):
        if v not in seen:
            order.append(v)
    g_adj = g.adjacency_sets()
    q_adj = q.adjacency_sets()
    results: list[tuple[int, ...]] = []
    mapping = [-1] * nq
    used: set[int] = set()

    def backtrack(pos: int) -> bool:
        if pos == nq:
            results.append(tuple(mapping))
            return limit is not None and len(results) >= limit
        u = order[pos]
        back = [w for w in q_adj[u] if mapping[w] >= 0]
        if back:
            cand = set(g_adj[mapping[back[0]]])
            for w in back[1:]:
                cand &= g_adj[mapping[w]]
        else:
            cand = set(range(g.n_vertices))
        lab = int(q.labels[u])
        for v in sorted(cand):
            if v in used or int(g.labels[v]) != lab:
                continue
            ok = all(mapping[w] in g_adj[v] for w in back)
            if not ok:
                continue
            mapping[u] = v
            used.add(v)
            if backtrack(pos + 1):
                return True
            used.discard(v)
            mapping[u] = -1
        return False

    backtrack(0)
    return results


def gql_match(g: Graph, q: Graph, limit: int | None = None) -> list[tuple[int, ...]]:
    """GraphQL-style: neighbor-label-profile candidate filtering, then search."""
    nq = q.n_vertices
    g_deg, q_deg = g.degrees, q.degrees

    def profile(graph: Graph, v: int) -> dict[int, int]:
        p: dict[int, int] = {}
        for w in graph.neighbors(v):
            lab = int(graph.labels[w])
            p[lab] = p.get(lab, 0) + 1
        return p

    g_prof = [profile(g, v) for v in range(g.n_vertices)]
    cand_sets: list[list[int]] = []
    for u in range(nq):
        pu = profile(q, u)
        lab = int(q.labels[u])
        cand = []
        for v in range(g.n_vertices):
            if int(g.labels[v]) != lab or g_deg[v] < q_deg[u]:
                continue
            pv = g_prof[v]
            if all(pv.get(k, 0) >= c for k, c in pu.items()):
                cand.append(v)
        cand_sets.append(cand)

    order = sorted(range(nq), key=lambda u: len(cand_sets[u]))
    # reorder for connectivity
    conn_order = [order[0]]
    seen = {order[0]}
    q_adj = q.adjacency_sets()
    while len(conn_order) < nq:
        nxt = None
        for u in order:
            if u in seen:
                continue
            if any(w in seen for w in q_adj[u]):
                nxt = u
                break
        if nxt is None:
            nxt = next(u for u in order if u not in seen)
        conn_order.append(nxt)
        seen.add(nxt)

    g_adj = g.adjacency_sets()
    results: list[tuple[int, ...]] = []
    mapping = [-1] * nq
    used: set[int] = set()

    def backtrack(pos: int) -> bool:
        if pos == nq:
            results.append(tuple(mapping))
            return limit is not None and len(results) >= limit
        u = conn_order[pos]
        for v in cand_sets[u]:
            if v in used:
                continue
            if any(mapping[w] >= 0 and mapping[w] not in g_adj[v] for w in q_adj[u]):
                continue
            mapping[u] = v
            used.add(v)
            if backtrack(pos + 1):
                return True
            used.discard(v)
            mapping[u] = -1
        return False

    backtrack(0)
    return results


def match_count(g: Graph, q: Graph, induced: bool = False) -> int:
    return len(vf2_match(g, q, induced=induced))
