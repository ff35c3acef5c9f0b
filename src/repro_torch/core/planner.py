"""Cost-model-based query plan selection (paper §5, Alg. 4).

Selects a set Q of query paths of length l covering all query vertices,
minimizing ``Cost_Q(φ) = Σ w(p_q)`` (Eq. 9).  Weight strategies:

* ``deg`` — w(p) = −Σ deg(q_i)  (paper's default; AIP(deg) won their sweep)
* ``dr``  — w(p) = |DR(o(p_q))| estimated by probing the index (candidate
            counts in the dominated region)

Initial-path strategies: OIP / AIP / εIP (§5.2).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Callable

import numpy as np

from ..graphs import Graph, device_graph
from .paths import enumerate_paths

__all__ = ["QueryPlan", "plan_query", "candidate_plan_paths", "canonical_form"]


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    paths: list  # list of (l+1,) int tuples of query vertex ids
    cost: float
    strategy: str

    @property
    def n_paths(self) -> int:
        return len(self.paths)


def candidate_plan_paths(q: Graph, length: int) -> list:
    """The path universe Alg. 4 plans over: all length-``l`` simple paths,
    falling back to shorter lengths for degenerate queries.  Exposed so
    the engine can batch-probe exactly this set for ``weight="dr"``."""
    dq = device_graph(q, "cpu")
    roots = np.arange(q.n_vertices)
    all_paths = enumerate_paths(dq, roots, length)
    if all_paths.shape[0] == 0:
        # degenerate query (shorter than l): fall back to max-length paths
        for shorter in range(length - 1, 0, -1):
            all_paths = enumerate_paths(dq, roots, shorter)
            if all_paths.shape[0]:
                break
        else:
            all_paths = enumerate_paths(dq, roots, 0)
    return [tuple(row) for row in all_paths.tolist()]


def _dense_ranks(values: list) -> list:
    """Map arbitrary comparable values to dense ints, order-preserving."""
    lut = {v: i for i, v in enumerate(sorted(set(values)))}
    return [lut[v] for v in values]


_CANON_CACHE: dict = {}  # id(graph) -> (perm, key); evicted via weakref.finalize


def canonical_form(q: Graph) -> tuple[np.ndarray, bytes]:
    """Deterministic label/degree canonical ordering for plan caching.

    WL-style color refinement: start from (label, degree) colors and
    iterate ``color ← (color, sorted neighbor colors)`` until the color
    partition stabilizes; order vertices by (final color, original id).
    Returns ``(perm, key)`` where ``perm[i]`` is the original vertex at
    canonical position ``i`` and ``key`` byte-encodes the *relabeled*
    graph (labels + edge list under the ordering).  Equal keys therefore
    guarantee identical canonical graphs — a plan computed on one maps
    to the other through its own ``perm`` — so a cache keyed on ``key``
    is always sound; isomorphic queries that the refinement fails to
    align just miss the cache.  Queries are tiny (≪ the data graph), so
    the Python refinement loop is noise next to the greedy planner it
    short-circuits.  The serving hot path canonicalizes the same query
    instance for the result cache, the dr-plan cache AND the deg-plan
    cache, so the (perm, key) pair memoizes per graph object (weakref-
    evicted, like matcher's edge-key cache).
    """
    cached = _CANON_CACHE.get(id(q))
    if cached is not None:
        return cached
    n = q.n_vertices
    if n == 0:
        return np.zeros(0, np.int64), b"\x00"
    nbrs = [list(map(int, q.neighbors(v))) for v in range(n)]
    ranks = _dense_ranks([(int(q.labels[v]), len(nbrs[v])) for v in range(n)])
    n_classes = len(set(ranks))
    for _ in range(n):
        sig = [(ranks[v], tuple(sorted(ranks[u] for u in nbrs[v]))) for v in range(n)]
        ranks = _dense_ranks(sig)
        new_classes = len(set(ranks))
        if new_classes == n_classes:
            break
        n_classes = new_classes
    perm = np.asarray(sorted(range(n), key=lambda v: (ranks[v], v)), np.int64)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    edges = sorted(
        (min(int(inv[u]), int(inv[v])), max(int(inv[u]), int(inv[v])))
        for u, v in q.edge_array()
    )
    key = (
        np.asarray([n], np.int64).tobytes()
        + q.labels[perm].astype(np.int64).tobytes()
        + np.asarray(edges, np.int64).tobytes()
    )
    _CANON_CACHE[id(q)] = (perm, key)
    weakref.finalize(q, _CANON_CACHE.pop, id(q), None)
    return perm, key


def plan_query(
    q: Graph,
    length: int,
    strategy: str = "aip",
    weight: str = "deg",
    weight_fn: Callable[[tuple[int, ...]], float] | None = None,
    epsilon: int = 2,
    seed: int = 0,
    group_size: int = 1,
) -> QueryPlan:
    """Alg. 4. Returns the best covering path set under the cost model.

    For a GNN-PGE grouped index the ``dr`` ``weight_fn`` returns group
    fan-outs (surviving groups — the probe's actual unit of leaf work)
    instead of per-path candidate counts, which the grouped probe never
    materializes.  ``group_size`` then rescales those fan-outs to
    leaf-row units so the reported ``QueryPlan.cost`` stays comparable
    across index kinds; being a uniform positive scale it deliberately
    cannot change which plan is selected — the selection change comes
    from the fan-out weights themselves.
    """
    paths = candidate_plan_paths(q, length)
    deg = q.degrees

    if weight_fn is None:
        if weight == "deg":
            weight_fn = lambda p: -float(sum(deg[v] for v in p))  # noqa: E731
        else:
            raise ValueError("weight='dr' requires an explicit weight_fn (index probe)")
    scale = float(group_size) if (weight == "dr" and group_size > 1) else 1.0
    w = {p: scale * weight_fn(p) for p in paths}

    # line 2: highest-degree starting vertex
    start = int(np.argmax(deg))
    through = [p for p in paths if start in p]
    if not through:
        through = paths
    rng = np.random.default_rng(seed)
    if strategy == "oip":
        initial = [min(through, key=lambda p: w[p])]
    elif strategy == "aip":
        initial = list(through)
    elif strategy == "eip":
        k = min(epsilon, len(through))
        sel = rng.choice(len(through), size=k, replace=False)
        initial = [through[i] for i in sel]
    else:
        raise ValueError(f"unknown strategy {strategy}")

    n_q = q.n_vertices
    # vectorized greedy scoring: membership matrix + weight vector, so each
    # greedy step is one NumPy pass over ALL candidate paths instead of a
    # per-candidate Python loop (ROADMAP planner item).  Simple paths have
    # distinct vertices, so |p ∩ cov| is a masked row sum of M.
    n_paths_all = len(paths)
    M = np.zeros((n_paths_all, n_q), bool)
    for i, p in enumerate(paths):
        M[i, list(p)] = True
    sizes = M.sum(axis=1)
    w_arr = np.asarray([w[p] for p in paths], np.float64)
    path_index = {p: i for i, p in enumerate(paths)}
    best_q: list[tuple[int, ...]] | None = None
    best_cost = float("inf")
    for p0 in initial:
        in_local = np.zeros(n_paths_all, bool)
        in_local[path_index[p0]] = True
        order = [p0]
        cost = w[p0]
        cov = np.zeros(n_q, bool)
        cov[list(p0)] = True
        n_cov = int(cov.sum())
        stuck = False
        while n_cov < n_q:
            # one pass: prefer paths connecting to the covered set with min
            # (overlap, weight) — Alg. 4 line 7; fall back to disconnected
            # paths adding new vertices.  lexsort keys mirror the scalar
            # loop's (inter == 0, inter, w, first-index) tie-breaks exactly.
            inter = (M & cov[None, :]).sum(axis=1)
            valid = ~in_local & (sizes > inter)  # must add a new vertex
            idx = np.nonzero(valid)[0]
            if idx.size == 0:
                stuck = True
                break
            k = np.lexsort((idx, w_arr[idx], inter[idx], inter[idx] == 0))[0]
            bi = int(idx[k])
            best_p = paths[bi]
            in_local[bi] = True
            order.append(best_p)
            cost += w[best_p]
            cov |= M[bi]
            n_cov = int(cov.sum())
        if stuck:
            continue
        if cost < best_cost:
            best_cost = cost
            best_q = order
    if best_q is None:
        # coverage impossible at this length (rare, e.g. pendant chains):
        # greedily cover with shorter paths
        best_q = list(paths)
        best_cost = sum(w.get(p, 0.0) for p in best_q)
    return QueryPlan(paths=best_q, cost=float(best_cost), strategy=f"{strategy}({weight})")
