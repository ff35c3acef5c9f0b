"""Standing queries: continuous matching over the update stream.

A registered query gets a :class:`MatchDelta` (added and retracted
matches) on every update tick instead of being matched again from
scratch.  ``core/delta.py``'s touched-partition and fresh-row bookkeeping
decides who wakes up, and the fresh rows are probed on the engine's
device: their pairs go through ``probe_delta_multi``'s fused verdict, the
kernel K1 on the card and its plain version on the CPU (the port's rule
for every verdict, ``kernels/dominance_scan/ops.py``).

Exactness (the JAX package's argument, unchanged):

* **Retractions.**  ``apply_graph_update`` marks both endpoints of every
  effectively changed edge (and every added or removed vertex) touched.
  A valid match can only become invalid if one of its edges changed, so
  every retracted match holds a touched vertex: dropping the old matches
  with a touched vertex and re-deriving the touched ones misses nothing.
* **Additions.**  A match new at this epoch uses a changed edge, so it
  holds a touched vertex ``u``.  The plan's paths cover every query
  vertex, and ``main ∪ delta − tombstones`` is exactly the current
  graph's path set, which re-enumerates every path through a touched
  vertex into this epoch's fresh buffer rows (``FreshRows``): the plan
  path covering ``u`` joins through a fresh row.  Joining, for each plan
  position ``i`` with fresh candidates, old rows at positions ``< i``,
  fresh rows at ``i`` and old ∪ fresh at ``> i`` enumerates every touched
  match exactly once (old and fresh rows are disjoint: fresh rows hold a
  touched vertex, the kept old rows do not).
* **Cached candidates stay exact.**  The partition GNNs are frozen and an
  untouched vertex keeps its star, so an untouched row keeps its
  embedding: a plan path's candidates change only by losing rows with a
  touched vertex and gaining fresh rows that pass the leaf predicate.
  Candidates are kept as vertex paths, not row ids, so a compaction (a
  re-sort) never perturbs them.
* **Untouched subscriptions pay nothing.**  The result cache's
  invalidation predicate (``serve/cache.py``) decides: a subscription is
  affected only if a mutated partition gave it candidates, or a
  non-contributing mutated partition inserted paths whose label hash
  meets one of the plan's.  Otherwise its state is exactly unchanged and
  it advances its epoch with no probe and no join.

The cached candidates and query operands are tensors on the engine's
device; the accumulated match set is a host array.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.delta import paths_touching, probe_delta_multi
from ..core.index import hash_labels
from ..core.matcher import match_from_candidates, sort_matches
from ..device import is_device_fault
from ..obs.export import EVENTS
from ..obs.metrics import REGISTRY as _OBS

# the skip / incremental / full-refresh work ladder, cumulatively across
# all registries; the per-subscription split stays on Subscription
_M_STANDING = _OBS.counter(
    "gnnpe_standing_ticks_total",
    "Per-subscription tick outcomes on the standing-query work ladder",
    labels=("work",),
)

__all__ = [
    "MatchDelta",
    "StandingState",
    "Subscription",
    "StandingQueryRegistry",
    "advance_standing",
]


@dataclasses.dataclass(frozen=True)
class MatchDelta:
    """One epoch's incremental result for one standing query."""

    added: tuple  # match tuples new at this epoch, sorted
    retracted: tuple  # match tuples invalidated at this epoch, sorted
    epoch: int
    error: str = ""  # nonempty = terminal (subscription quarantined)

    @property
    def empty(self) -> bool:
        return not self.added and not self.retracted and not self.error


@dataclasses.dataclass
class StandingState:
    """Everything cached per standing query between update ticks.

    Candidates are VERTEX paths (device tensors), per plan path per
    partition: stable across compaction, which re-sorts rows but never
    changes which vertex paths are live.
    """

    plan: object  # QueryPlan, frozen at registration (exactness is plan-independent)
    plan_hashes: frozenset  # label-sequence hash per plan path (affectedness test)
    qt: dict  # (mi, path) -> (q_emb, q_emb0, q_multi, label_hash): frozen GNNs, so forever
    n_qv: int  # query vertex count
    epoch: int
    matches: np.ndarray  # (M, n_qv) int64, the current accumulated match set
    cands: list  # per plan path: {mi: (n, L) int64 candidate vertex paths}
    contributing: set  # partitions with any cached candidate row
    last_work: str = "full"  # "full" | "incremental" | "skip" | "noop"


# --------------------------------------------------------------------------
# Evaluation
# --------------------------------------------------------------------------


def _cat(per: dict, L: int, device) -> torch.Tensor:
    """One candidate tensor per plan path: the partitions' in model order."""
    if not per:
        return torch.zeros((0, L), dtype=torch.int64, device=device)
    arrs = [per[mi] for mi in sorted(per)]
    return arrs[0] if len(arrs) == 1 else torch.cat(arrs)


def _join(engine, q, plan_paths, cand_arrays) -> list:
    """Join + exact refine (the batch pipeline's ``match_from_candidates``;
    per-path rows are duplicate-free, so the dedup sorts are skipped)."""
    cfg = engine.cfg
    return match_from_candidates(
        engine.graph, engine.dgraph, q, plan_paths, cand_arrays,
        induced=cfg.induced, assume_unique=True, join_impl=cfg.join_impl,
    )


def _match_set(engine, q, plan, cands) -> list:
    dev = engine.device
    return _join(engine, q, plan.paths,
                 [_cat(cands[pi], len(p), dev) for pi, p in enumerate(plan.paths)])


def _full_candidates(engine, q, plan):
    """From-scratch probe of every plan path (registration, and the
    rebuild / epoch-gap fallback) → ``(cands, cat)``, ``cat`` the
    per-partition query-star embeddings (reused for ``qt``)."""
    cfg = engine.cfg
    q_embs = engine._query_node_embeddings_many([q])
    memo: dict = {}
    delta_memo: dict = {}
    engine._probe_batch(
        [(0, p) for p in plan.paths], q_embs, memo, [q], cfg.probe_impl,
        use_groups=cfg.index_kind == "grouped", delta_memo=delta_memo,
    )
    delta = engine.delta
    short = engine._short_paths(q, plan, {})
    cands = []
    for pi, p in enumerate(plan.paths):
        if pi in short:  # a path shorter than the index's: live-graph candidates
            cands.append(dict(short[pi]))
            continue
        per: dict = {}
        for mi, model in enumerate(engine.models):
            parts = []
            rows = memo.get((mi, 0, p))
            if rows is not None and rows.numel():
                parts.append(model.index.paths[rows])
            if delta is not None:
                drows = delta_memo.get((mi, 0, p))
                if drows is not None and drows.numel():
                    parts.append(delta.parts[mi].paths[drows])
            if parts:
                per[mi] = parts[0] if len(parts) == 1 else torch.cat(parts)
        cands.append(per)
    return cands, q_embs[0]


def _label_hash(q, p) -> int:
    labels = torch.as_tensor(q.labels[np.asarray(p, np.int64)].astype(np.int64))
    return int(hash_labels(labels[None, :])[0])


def _query_tensors(engine, q, plan, cat) -> dict:
    """Per-(partition, plan path) probe operands for later fresh-row scans.
    The GNNs are frozen and these depend only on the query, so they are
    computed once, at registration."""
    cfg = engine.cfg
    qt: dict = {}
    for p in plan.paths:
        pv = torch.as_tensor(p, dtype=torch.int64, device=engine.device)
        qh = _label_hash(q, p) if cfg.quantize_index else None
        for mi in range(len(engine.models)):
            o, o0, om = cat[mi]
            q_multi = om[:, pv].reshape(cfg.n_multi, -1) if cfg.n_multi else None
            qt[(mi, p)] = (o[pv].reshape(-1), o0[pv].reshape(-1), q_multi, qh)
    return qt


def _as_array(matches, n_qv: int) -> np.ndarray:
    if not len(matches):
        return np.zeros((0, n_qv), np.int64)
    return np.asarray(sort_matches(list(matches)), np.int64).reshape(-1, n_qv)


def _tuples(arr: np.ndarray) -> set:
    return {tuple(int(v) for v in row) for row in arr}


def _register(engine, q):
    plan = engine._deg_plan_cached(q)
    cands, cat = _full_candidates(engine, q, plan)
    matches = _match_set(engine, q, plan, cands)
    state = StandingState(
        plan=plan,
        plan_hashes=frozenset(_label_hash(q, p) for p in plan.paths),
        qt=_query_tensors(engine, q, plan, cat),
        n_qv=q.n_vertices,
        epoch=engine.epoch,
        matches=_as_array(matches, q.n_vertices),
        cands=cands,
        contributing={mi for per in cands for mi in per},
        last_work="full",
    )
    added = tuple(sort_matches([tuple(int(v) for v in m) for m in matches]))
    return state, MatchDelta(added=added, retracted=(), epoch=engine.epoch)


def _refresh(engine, q, state: StandingState):
    """Full re-evaluation diffed against the accumulated set: the fallback
    for rebuild epochs and multi-epoch gaps (a subscription that missed a
    tick, e.g. after a transient fault)."""
    cands, _ = _full_candidates(engine, q, state.plan)
    matches = _match_set(engine, q, state.plan, cands)
    new_set = {tuple(int(v) for v in m) for m in matches}
    old_set = _tuples(state.matches)
    state.cands = cands
    state.contributing = {mi for per in cands for mi in per}
    state.matches = _as_array(new_set, state.n_qv)
    state.epoch = engine.epoch
    state.last_work = "full"
    return state, MatchDelta(
        added=tuple(sorted(new_set - old_set)),
        retracted=tuple(sorted(old_set - new_set)),
        epoch=engine.epoch,
    )


def _affected(state: StandingState, mutated: dict) -> bool:
    """The result cache's invalidation predicate, for one subscription."""
    mut = {int(mi) for mi in mutated}
    if mut & state.contributing:
        return True
    inserted: set = set()
    for mi, info in mutated.items():
        if int(mi) in state.contributing:
            continue
        hashes = info.get("inserted_hashes")
        if hashes is not None:
            inserted.update(int(h) for h in np.asarray(hashes).reshape(-1))
    return bool(inserted & state.plan_hashes)


def _advance(engine, q, state: StandingState, upd: dict):
    """One incremental epoch step.  Commits to ``state`` only at the end,
    so an exception (an injected transient fault, say) leaves the previous
    epoch's state intact for a clean retry."""
    cfg = engine.cfg
    dev = engine.device
    touched = np.asarray(upd["touched"], np.int64)
    mutated = upd["mutated"]
    fresh_map = upd["fresh"]
    plan_paths = state.plan.paths
    k = len(plan_paths)

    # 1. old candidates minus the rows holding a touched vertex (only
    # mutated partitions can hold any; see _affected)
    old_cands: list = []
    for pi in range(k):
        per: dict = {}
        for mi, arr in state.cands[pi].items():
            if mi in mutated:
                arr = arr[~paths_touching(arr, touched)]
            if arr.shape[0]:
                per[mi] = arr
        old_cands.append(per)

    # 2. probe ONLY this epoch's fresh buffer rows, all plan paths of a
    # partition as one probe item, one fused verdict overall
    fresh_cands: list = [dict() for _ in range(k)]
    items, meta = [], []
    for mi, fresh in fresh_map.items():
        sel = [pi for pi, p in enumerate(plan_paths) if len(p) == fresh.paths.shape[1]]
        if not sel:
            continue
        rows_q = [state.qt[(mi, plan_paths[pi])] for pi in sel]
        q_multi = torch.stack([t[2] for t in rows_q], dim=1) if cfg.n_multi else None
        qh = None
        if cfg.quantize_index:
            qh = torch.tensor([t[3] for t in rows_q], dtype=torch.int64, device=dev)
        items.append((fresh, torch.stack([t[0] for t in rows_q]),
                      torch.stack([t[1] for t in rows_q]), q_multi, qh))
        meta.append((mi, sel))
    if items:
        out = probe_delta_multi(items, pair_cap=cfg.stacked_leaf_pair_cap)
        for (mi, sel), rows_list in zip(meta, out):
            for pi, rows in zip(sel, rows_list):
                if rows.numel():
                    fresh_cands[pi][mi] = fresh_map[mi].paths[rows]

    # 3. the touched matches of the new graph, split by the first fresh
    # position (old at < i, fresh at i, old ∪ fresh at > i): each touched
    # match joins through exactly one of these products
    O = [_cat(old_cands[pi], len(plan_paths[pi]), dev) for pi in range(k)]
    F = [_cat(fresh_cands[pi], len(plan_paths[pi]), dev) for pi in range(k)]
    full = [O[i] if F[i].shape[0] == 0 else torch.cat([O[i], F[i]]) for i in range(k)]
    t_new: set = set()
    for i in range(k):
        if F[i].shape[0] == 0:
            continue
        cand = [O[j] if j < i else (F[j] if j == i else full[j]) for j in range(k)]
        t_new.update(tuple(int(v) for v in m) for m in _join(engine, q, plan_paths, cand))

    # 4. diff against the accumulated set
    old = state.matches
    tmask = np.zeros(old.shape[0], bool)
    if old.shape[0] and touched.size:
        tmask = np.isin(old, touched).any(axis=1)
    survivors = old[~tmask]
    old_touched = _tuples(old[tmask])
    added = tuple(sorted(t_new - old_touched))
    retracted = tuple(sorted(old_touched - t_new))

    # 5. commit
    merged: list = []
    for pi in range(k):
        per = dict(old_cands[pi])
        for mi, arr in fresh_cands[pi].items():
            per[mi] = arr if mi not in per else torch.cat([per[mi], arr])
        merged.append(per)
    state.cands = merged
    state.contributing = {mi for per in merged for mi in per}
    new_rows = _as_array(t_new, state.n_qv)
    if survivors.shape[0] == 0:
        state.matches = new_rows
    elif new_rows.shape[0] == 0:
        state.matches = survivors
    else:
        state.matches = np.concatenate([survivors, new_rows])
    state.epoch = engine.epoch
    state.last_work = "incremental"
    return state, MatchDelta(added=added, retracted=retracted, epoch=engine.epoch)


def advance_standing(engine, q, state: StandingState | None = None):
    """Bring one standing query to the engine's current epoch → ``(state,
    MatchDelta)``.  ``state=None`` registers (a full evaluation, everything
    reported as added).  Otherwise, in order of preference: nothing
    (already current), a free epoch bump (unaffected by this epoch's
    mutations), the incremental fresh-row step, or a full refresh (rebuild
    epochs, multi-epoch gaps, and every new epoch of a query whose plan
    has a path shorter than the index's)."""
    if state is None:
        return _register(engine, q)
    if state.epoch == engine.epoch:
        state.last_work = "noop"
        return state, MatchDelta((), (), engine.epoch)
    upd = engine.epoch_fresh()
    if (
        upd is None
        or upd["epoch"] != engine.epoch
        or upd.get("strategy") != "delta"
        or state.epoch != engine.epoch - 1
        or engine.has_short_paths(state.plan)  # no fresh rows hold a shorter path
    ):
        return _refresh(engine, q, state)
    mutated = upd["mutated"]
    if mutated and _affected(state, mutated):
        return _advance(engine, q, state, upd)
    state.epoch = engine.epoch
    state.last_work = "skip"
    return state, MatchDelta((), (), engine.epoch)


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Subscription:
    sub_id: int
    query: object
    state: StandingState | None
    callback: object = None  # callable(sub_id, MatchDelta) or None
    tenant: str = ""
    failures: int = 0  # consecutive, reset on success
    n_skipped: int = 0
    n_advanced: int = 0
    n_refreshed: int = 0
    quarantined: bool = False
    error: str = ""


class StandingQueryRegistry:
    """Standing queries over one engine's update stream.

    ``on_epoch()`` (the subscription tick) advances every active
    subscription to the engine's current epoch and returns the non-empty
    deltas; callbacks fire on the calling (engine) thread.  A subscription
    whose evaluation keeps failing deterministically is quarantined after
    ``max_failures`` consecutive errors; a transient fault
    (``exc.transient``) only counts as a retry.  A kernel or device fault
    (``device.is_device_fault``) is re-raised: no subscription caused it.
    """

    def __init__(self, engine, max_failures: int = 3):
        self.engine = engine
        self.max_failures = max_failures
        self._subs: dict[int, Subscription] = {}
        self._next_id = 0
        self.counters = {
            "ticks": 0,
            "advanced": 0,
            "skipped": 0,
            "refreshed": 0,
            "quarantined": 0,
            "transient_errors": 0,
        }

    # ------------------------------------------------------------------
    def register(self, q, callback=None, tenant: str = "", sub_id: int | None = None) -> tuple:
        """Register a standing query → ``(sub_id, MatchDelta)``, the initial
        full evaluation as ``added`` (the callback is NOT called for it: the
        caller holds the delta).  ``sub_id`` pins the id."""
        state, delta = self.engine.match_incremental(q, None)
        if sub_id is None:
            sid = self._next_id
            self._next_id += 1
        else:
            sid = int(sub_id)
            if sid in self._subs:
                raise ValueError(f"subscription id {sid} already registered")
            self._next_id = max(self._next_id, sid + 1)
        self._subs[sid] = Subscription(
            sub_id=sid, query=q, state=state, callback=callback, tenant=tenant
        )
        return sid, delta

    def unregister(self, sub_id: int) -> bool:
        return self._subs.pop(sub_id, None) is not None

    def subscription(self, sub_id: int) -> Subscription:
        return self._subs[sub_id]

    def matches(self, sub_id: int) -> list:
        """The accumulated current match set, canonically ordered."""
        st = self._subs[sub_id].state
        if st is None:
            return []
        return sort_matches([tuple(int(v) for v in row) for row in st.matches])

    def lagging(self) -> bool:
        """Any active subscription behind the engine epoch (after a
        transient fault, say)?  The service's heartbeat retries these."""
        epoch = self.engine.epoch
        return any(
            not s.quarantined and (s.state is None or s.state.epoch != epoch)
            for s in self._subs.values()
        )

    # ------------------------------------------------------------------
    def on_epoch(self) -> dict:
        """Advance every active subscription → ``{sub_id: MatchDelta}`` for
        the ones with changes (or a terminal quarantine error)."""
        out: dict[int, MatchDelta] = {}
        self.counters["ticks"] += 1
        epoch = self.engine.epoch
        for sid, sub in list(self._subs.items()):
            if sub.quarantined:
                continue
            if sub.state is not None and sub.state.epoch == epoch:
                continue
            try:
                sub.state, delta = self.engine.match_incremental(sub.query, sub.state)
            except Exception as exc:  # noqa: BLE001 — fault boundary per sub
                if is_device_fault(exc):
                    raise
                sub.failures += 1
                if getattr(exc, "transient", False):
                    # attempt-scoped: the state is untouched; retry next tick
                    self.counters["transient_errors"] += 1
                    _M_STANDING.labels(work="transient-error").inc()
                    continue
                if sub.failures < self.max_failures:
                    continue
                sub.quarantined = True
                sub.error = f"{type(exc).__name__}: {exc}"
                self.counters["quarantined"] += 1
                _M_STANDING.labels(work="quarantined").inc()
                if EVENTS.active:
                    EVENTS.emit(
                        "quarantine", kind="standing", sub_id=sid,
                        tenant=sub.tenant, reason=sub.error,
                    )
                delta = MatchDelta((), (), epoch, error=sub.error)
                out[sid] = delta
                if sub.callback is not None:
                    sub.callback(sid, delta)
                continue
            sub.failures = 0
            work = sub.state.last_work
            if work == "skip":
                sub.n_skipped += 1
                self.counters["skipped"] += 1
                _M_STANDING.labels(work="skip").inc()
            elif work == "full":
                sub.n_refreshed += 1
                self.counters["refreshed"] += 1
                _M_STANDING.labels(work="full").inc()
            elif work == "incremental":
                sub.n_advanced += 1
                self.counters["advanced"] += 1
                _M_STANDING.labels(work="incremental").inc()
            if not delta.empty:
                out[sid] = delta
                if sub.callback is not None:
                    sub.callback(sid, delta)
        return out

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        active = [s for s in self._subs.values() if not s.quarantined]
        return {
            "n_subscriptions": len(self._subs),
            "n_active": len(active),
            **self.counters,
        }
