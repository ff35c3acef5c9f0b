"""The stacked index probe: one batched descent over every partition's
stacked tensors, split over the devices of a ``part`` list, then one leaf
stage across all of them.

``core/stacked.py`` lays every partition's packed forest into dense
(S, …) tensors; this module runs the online filter over them:

  1. **device stage**: the level-synchronous MBR descent (Lemmas 4.3 and
     4.4) and, for a grouped index, the GNN-PGE group scan, as batched
     tensor ops over the leading slot dimension, with no Python loop over
     partitions.  Over a ``part`` list of n devices (the JAX package's
     ``("part",)`` mesh: in-process, no collective in the math) the slots
     split into the n equal runs ``build_stacked(n_shards=n)`` laid out,
     each run's level and group bounds live on its device and descend
     there, and the masks are concatenated in slot order on the first
     device, where the indexes live.  Queries go in chunks so that no
     intermediate exceeds
     ``_MASK_BUDGET`` bytes.  ``device_stage="numpy"`` runs the plain
     ``stacked_masks_ref`` instead (the JAX package's name for the switch);
  2. **leaf stage**: the surviving (slot, query, block or group) cells
     expand to (query, row) pairs on the device (``repeat_interleave`` over
     a ``cumsum``) as flat indices into the stacked tables, in chunks of
     about ``leaf_pair_cap`` pairs, each through the conservative int8 +
     label-hash prefilter and then one fused verdict,
     ``index._pairs_keep_mask``: the kernel K1 on the card, reading the
     stacked tables in place, its plain version on the CPU.

``probe`` returns the rows per (partition, query), equal to
``query_index_batch_multi``'s over the source indexes, in the same order,
reading a few small tensors back to the host, not one per partition.
``probe_device`` is the hand-off to the device join: the kept rows' path
vertices gather on the device and compact into one int32 tensor per probe,
concatenated across the partitions in slot order, and only counts come
back to the host.  Where the pairs exceed ``leaf_pair_cap`` it takes
``probe``'s chunked path and concatenates in engine order, as the JAX
package does.  Under live updates both take ``live_mask``, the engine's
(S, P_max) tombstone mask, applied to the pairs after the prefilter, and
``update_slot`` re-stacks one compacted partition's slot.  A cluster host
(``dist/cluster.py``) runs the same probe over a stack of just the
partitions it owns.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import index as index_mod
from ..core.index import NO_SIDECAR, _eps, _expand_segments, quantize_query
from ..core.stacked import build_stacked, restack_slot, stacked_masks_ref
from ..kernels.dominance_scan.ops import Segment
from ..obs import trace as obs_trace
from .context import mesh_devices

__all__ = ["StackedProbe"]

_MASK_BUDGET = 256 << 20  # bytes of the largest descent intermediate
_STAT_KEYS = tuple(index_mod._NO_GROUP_STATS)  # the loop probe's stats, grouped


def _canon(d) -> torch.device:
    """``d`` with the current card's index where it names none."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class StackedProbe:
    """Runs the probe over a ``StackedIndex`` built from ``indexes`` on
    their device (see the module doc).

    ``devices``: the ``part`` list the descent splits over, its first entry
    the indexes' device; None takes ``dist.context.mesh_devices("part",
    ...)`` (the scoped list, else every visible card).  The slots are laid
    out over its length (``build_stacked(n_shards=...)``), or as
    ``slot_of`` gives them (a restored donor's layout).

    ``leaf_pair_cap`` bounds the cross-partition leaf expansion: the
    surviving cells expand in chunks of about ``cap`` (query, row) pairs,
    each through the prefilter and one fused verdict before the next
    exists, and ``probe_device`` keeps its pairs on the device only up to
    ``cap``.  The rows are the same for any cap.
    """

    def __init__(self, indexes: list, leaf_pair_cap: int = 1 << 21, slot_of=None,
                 devices=None):
        if leaf_pair_cap < 1:
            raise ValueError(f"leaf_pair_cap must be >= 1, got {leaf_pair_cap}")
        if not indexes:
            raise ValueError("StackedProbe needs at least one PackedIndex")
        home = indexes[0].emb.device
        devices = mesh_devices("part", home) if devices is None else devices
        self.devices = [torch.device(d) for d in devices]
        if not self.devices or _canon(self.devices[0]) != _canon(home):
            raise ValueError(f"the part list {self.devices} must start with the indexes' "
                             f"device {home}")
        self.leaf_pair_cap = int(leaf_pair_cap)
        self.stacked = build_stacked(indexes, len(self.devices), slot_of)
        st = self.stacked
        self._indexes = list(indexes)  # the hand-off's paths tensor is built from them
        self._paths: torch.Tensor | None = None
        self._slot_of = torch.as_tensor(st.slot_of, device=st.device)
        self._refresh()
        # per-partition (query, row) leaf pairs scanned, engine order,
        # cumulative over the probe's lifetime like the pair counter
        self.part_leaf_pairs = np.zeros(st.n_parts, np.int64)
        # calls whose leaf stage split rows per (partition, query) through
        # ``probe`` (``probe_device`` moves it only on its fallback)
        self.host_expansions = 0

    def _refresh(self) -> None:
        """The tensors derived from the stacked layout: the groups present in
        each leaf block, (S, B_leaf) (the group pairs a surviving block
        costs), the path total, and each shard's slot run with its level and
        group bounds on its device."""
        st = self.stacked
        self._gib = None
        if st.groups is not None:
            self._gib = (st.groups.count.reshape(st.n_slots, -1, st.groups.gpb) > 0).sum(dim=2)
        self._total_paths = int(st.n_paths.sum())
        per = st.n_slots // len(self.devices)
        self._shards = []
        for k, dev in enumerate(self.devices):
            run = slice(k * per, (k + 1) * per)
            levels = [tuple(t[run].to(dev) for t in b)
                      for b in zip(st.level_hi, st.level_lo0, st.level_hi0)]
            g = st.groups
            groups = None if g is None else tuple(t[run].to(dev) for t in (g.hi, g.lo0, g.hi0))
            self._shards.append((run, dev, levels, groups))

    def update_slot(self, part_i: int, index) -> bool:
        """Elastic re-stacking after partition ``part_i`` compacted: only its
        slot is rewritten (``core.stacked.restack_slot``) and the hand-off's
        paths tensor is dropped, to be built again at the next hand-off;
        ``slot_of`` stays.  False where the slot cannot take the new index
        (its level count grew): the caller stacks anew."""
        if not restack_slot(self.stacked, int(self.stacked.slot_of[part_i]), index):
            return False
        self._indexes[part_i] = index
        self._paths = None
        self._refresh()
        return True

    def _leaf_tensors(self) -> torch.Tensor:
        """Every partition's path vertices as one (S, P_max, L) int32 tensor
        in the stacked row layout, built at the first hand-off."""
        if self._paths is None:
            st = self.stacked
            L = int(self._indexes[0].paths.shape[1])
            self._paths = torch.zeros((st.n_slots, st.emb_cat.shape[1], L), dtype=torch.int32,
                                      device=st.device)
            for i, ix in enumerate(self._indexes):
                if ix.n_paths:
                    self._paths[int(st.slot_of[i]), : ix.n_paths] = ix.paths.to(torch.int32)
        return self._paths

    def _check(self, n_parts: int, use_groups: bool) -> None:
        st = self.stacked
        if n_parts != st.n_parts:
            raise ValueError(f"expected {st.n_parts} partitions, got {n_parts}")
        if use_groups and st.groups is None and self._total_paths:
            raise ValueError(NO_SIDECAR)

    def _slot_queries(self, q_emb, q_emb0, q_multi) -> tuple:
        """Engine-order per-partition queries scattered into their slots →
        (q_cat (S, Q, Dcat), q0 (S, Q, D0)); filler slots get 0⃗."""
        st = self.stacked
        cat = torch.cat([q_emb, *q_multi], dim=2) if st.n_gnn else q_emb
        q_cat = cat.new_zeros((st.n_slots,) + tuple(cat.shape[1:]))
        q0 = q_emb0.new_zeros((st.n_slots,) + tuple(q_emb0.shape[1:]))
        q_cat[self._slot_of] = cat
        q0[self._slot_of] = q_emb0
        return q_cat, q0

    # ------------------------------------------------------------------
    # device stage: the batched dense descent and group scan
    # ------------------------------------------------------------------
    def _device_masks(self, q_cat, q0, eps: float, device_stage: str, use_groups: bool = False):
        """(S, Q, Dcat/D0) query tensors → (alive (S, Q, B_leaf), gkeep (S,
        Q, G) or None), on the indexes' device: each shard's run of slots
        descends on its own device, the masks concatenated in slot order."""
        if device_stage == "numpy":
            return stacked_masks_ref(self.stacked, q_cat, q0, eps, use_groups)
        if device_stage != "batched":
            raise ValueError(f"unknown device_stage {device_stage!r}; use 'batched' or 'numpy'")
        home = self.stacked.device
        alive, gkeep = [], []
        for run, dev, levels, groups in self._shards:
            a, g = self._descend(levels, groups if use_groups else None,
                                 q_cat[run].to(dev), q0[run].to(dev), eps)
            alive.append(a.to(home))
            gkeep.append(None if g is None else g.to(home))
        if len(alive) == 1:
            return alive[0], gkeep[0]
        return torch.cat(alive), (torch.cat(gkeep) if use_groups else None)

    def _descend(self, levels: list, groups, q_cat, q0, eps: float):
        """The dense descent of one run of slots on its device: (alive (s, Q,
        B_leaf), gkeep (s, Q, G) or None)."""
        st = self.stacked
        e = _eps(eps, q_cat.device)

        def widened(hi, lo0, hi0):
            # the float32 ``bound ± eps`` the compares need, once a call
            return (hi + e)[:, None], (hi0 + e)[:, None], (lo0 - e)[:, None]

        levels = [widened(*b) for b in levels]
        bounds = levels + ([widened(*groups)] if groups is not None else [])
        S, Q = q_cat.shape[:2]
        widest = max(hi.shape[2] for hi, _, _ in bounds) * max(q_cat.shape[2], q0.shape[2])
        qc = max(1, _MASK_BUDGET // max(S * widest, 1))
        alive_out, gkeep_out = [], []
        for a in range(0, Q, qc):
            qa = q_cat[:, a : a + qc, None, :]
            q0a = q0[:, a : a + qc, None, :]

            def passes(hi_e, hi0_e, lo0_e):
                m = (qa <= hi_e).all(dim=-1)
                m &= (q0a <= hi0_e).all(dim=-1)
                m &= (q0a >= lo0_e).all(dim=-1)
                return m

            alive = None
            for b in levels:
                m = passes(*b)
                if alive is not None:
                    m &= alive.repeat_interleave(st.fanout, dim=2)[:, :, : m.shape[2]]
                alive = m
            alive_out.append(alive)
            if groups is not None:
                gkeep_out.append(alive.repeat_interleave(st.groups.gpb, dim=2)
                                 & passes(*bounds[-1]))
        alive = torch.cat(alive_out, dim=1)
        return alive, (torch.cat(gkeep_out, dim=1) if groups is not None else None)

    # ------------------------------------------------------------------
    # leaf stage: cells → (query, row) pairs → prefilter → K1
    # ------------------------------------------------------------------
    def _cells(self, alive, gkeep) -> tuple:
        """Surviving (slot, query, block or group) cells → (pi, qi, starts,
        counts): each cell's first row in its slot and its rows.
        ``nonzero``'s row-major order makes them (slot, query)-major."""
        st = self.stacked
        if gkeep is not None:
            with obs_trace.host_sync():
                pi, qi, gi = torch.nonzero(gkeep, as_tuple=True)
            return pi, qi, st.groups.start[pi, gi], st.groups.count[pi, gi]
        with obs_trace.host_sync():
            pi, qi, bi = torch.nonzero(alive, as_tuple=True)
        starts = bi * st.block_size
        return pi, qi, starts, torch.clamp(st.n_paths[pi] - starts, 0, st.block_size)

    def _checked_groups(self, alive) -> torch.Tensor:
        """(S, Q) groups checked: the groups of each surviving leaf block,
        as the loop probe counts its group pairs."""
        return (alive * self._gib[:, None, :]).sum(dim=2)

    def _group_pairs(self, checked) -> torch.Tensor:
        """(1,) the group pairs checked in all (0 without groups)."""
        if checked is None:
            return torch.zeros(1, dtype=torch.int64, device=self.stacked.device)
        return checked.sum().view(1)

    def _prefilter_queries(self, q_cat, q_label_hash, any_pairs: bool) -> tuple:
        """The query side of the int8 + label-hash prefilter, or Nones."""
        st = self.stacked
        if not any_pairs or st.emb_q is None:
            return None, None
        qh = None
        if st.label_hash is not None and q_label_hash is not None:
            qh = q_label_hash.to(st.device)
        return quantize_query(q_cat), qh

    def _pairs(self, pi, qi, starts, counts, n: int, q_cat, q0, qq, qh, eps: float,
               live=None) -> tuple:
        """Cells with ``n`` rows in all → their pairs, through the prefilter
        and the tombstone mask ``live`` (S, P_max), then ONE fused verdict:
        K1 on one segment over the stacked tables, read in place through the
        flat indices ``slot·P_max + row`` and ``slot·Q + query`` → the kept
        (flat rows, flat queries), in cell order."""
        st = self.stacked
        S, P, Dcat = st.emb_cat.shape
        Q = q_cat.shape[1]
        rows = _expand_segments(pi * P + starts, counts, n)
        combo = torch.repeat_interleave(pi * Q + qi, counts, output_size=n)
        pre = None
        if qq is not None:  # the conservative int8 + label-hash prefilter
            pre = (qq.reshape(S * Q, Dcat)[combo]
                   <= st.emb_q.reshape(S * P, Dcat)[rows]).all(dim=1)
            if qh is not None:
                pre &= st.label_hash.reshape(-1)[rows] == qh.repeat(S)[combo]
        if live is not None:  # tombstoned main rows are no candidates
            alive = live.reshape(-1)[rows]
            pre = alive if pre is None else pre & alive
        if pre is not None:
            with obs_trace.host_sync():
                sel = torch.nonzero(pre).flatten()
            rows, combo = rows[sel], combo[sel]
        # exact Lemma 4.1 + 4.2 verdicts: one fused pass
        W = Dcat // (1 + st.n_gnn)
        seg = Segment(
            rows, combo,
            (*st.emb_cat.reshape(S * P, Dcat).split(W, dim=1), st.emb0.reshape(S * P, -1)),
            (*q_cat.reshape(S * Q, Dcat).split(W, dim=1), q0.reshape(S * Q, -1)),
        )
        keep = index_mod._pairs_keep_mask([seg], eps)
        with obs_trace.host_sync():
            sel = torch.nonzero(keep).flatten()
        return rows[sel], combo[sel]

    def _stats(self, alive, gkeep, checked, pi, qi, counts) -> torch.Tensor:
        """(S, Q, k) per-(slot, query) stats, the loop probe's semantics, in
        ``_STAT_KEYS`` order (k = 4 with groups; else scanned blocks and
        paths)."""
        st = self.stacked
        scanned = alive.sum(dim=2)
        if gkeep is None:
            return torch.stack([scanned, scanned * st.block_size], dim=2)
        S, Q = scanned.shape
        member = torch.zeros(S * Q, dtype=torch.int64, device=st.device).index_add_(
            0, pi * Q + qi, counts
        )
        return torch.stack([scanned, checked, gkeep.sum(dim=2), member.view(S, Q)], dim=2)

    def _stats_dicts(self, table: np.ndarray, use_groups: bool) -> list:
        """(S, Q, k) host stats → per partition (engine order), per query dicts."""
        keys = _STAT_KEYS if use_groups else (_STAT_KEYS[0], _STAT_KEYS[3])
        return [
            [dict(zip(keys, map(int, row))) for row in table[int(s)]]
            for s in self.stacked.slot_of
        ]

    def _zero_stats(self, n_parts: int, Q: int, use_groups: bool) -> list:
        keys = _STAT_KEYS if use_groups else (_STAT_KEYS[0], _STAT_KEYS[3])
        return [[dict.fromkeys(keys, 0) for _ in range(Q)] for _ in range(n_parts)]

    # ------------------------------------------------------------------
    # the probe: rows per (partition, query)
    # ------------------------------------------------------------------
    def probe(
        self,
        q_emb: torch.Tensor,  # (n_parts, Q, D) per-partition query embeddings
        q_emb0: torch.Tensor,  # (n_parts, Q, D0)
        q_multi: torch.Tensor | None = None,  # (n_gnn, n_parts, Q, D)
        q_label_hash: torch.Tensor | None = None,  # (Q,) int64, shared
        eps: float = 1e-6,
        use_groups: bool = False,
        device_stage: str = "batched",
        return_stats: bool = False,
        live_mask: torch.Tensor | None = None,  # (S, P_max) bool; None: all live
    ):
        """Candidate rows for Q query paths against every partition.

        Returns a list (per partition, engine order) of lists (per query)
        of int64 row tensors: the rows, in the order, of
        ``query_index_batch_multi`` over the source indexes (with
        ``use_groups``, its two-level probe), less the rows ``live_mask``
        marks dead; with ``return_stats`` also its per-partition per-query
        stats dicts.  The leaf pairs scanned add to ``part_leaf_pairs``.
        """
        st = self.stacked
        dev = st.device
        n_parts, Q = q_emb.shape[:2]
        self._check(n_parts, use_groups)
        empty = torch.zeros((0,), dtype=torch.int64, device=dev)
        if Q == 0 or self._total_paths == 0:
            results = [[empty] * Q for _ in range(n_parts)]
            return (results, self._zero_stats(n_parts, Q, use_groups)) if return_stats else results
        S = st.n_slots
        q_cat, q0 = self._slot_queries(q_emb, q_emb0, q_multi)
        with obs_trace.span("probe.descent", device=dev):
            alive, gkeep = self._device_masks(q_cat, q0, eps, device_stage, use_groups)
        pi, qi, starts, counts = self._cells(alive, gkeep)
        checked = self._checked_groups(alive) if use_groups else None
        ends = torch.cumsum(counts, 0)
        cell_start = ends - counts
        n_cells = int(pi.numel())
        # chunks are contiguous cell ranges: a cell joins chunk
        # cell_start // leaf_pair_cap, as in the JAX package; one read-back
        # gives every chunk's first cell and first pair, and the group pairs
        head = [torch.zeros(1, dtype=torch.int64, device=dev)] * 2
        if n_cells:
            chunk_of = cell_start // self.leaf_pair_cap
            first = torch.ones(n_cells, dtype=torch.bool, device=dev)
            first[1:] = chunk_of[1:] != chunk_of[:-1]
            with obs_trace.host_sync():
                firsts = torch.nonzero(first).flatten()
            head = [
                torch.cat([firsts, firsts.new_full((1,), n_cells)]),
                torch.cat([cell_start[firsts], ends[-1:]]),
            ]
        with obs_trace.host_sync():
            host = torch.cat([*head, self._group_pairs(checked)]).cpu().numpy()
        host, group_pairs = host[:-1].reshape(2, -1), int(host[-1])
        total_pairs = int(host[1, -1])
        index_mod._LEAF_PAIRS.inc(total_pairs)
        index_mod._GROUP_PAIRS.inc(group_pairs)
        qq, qh = self._prefilter_queries(q_cat, q_label_hash, total_pairs > 0)
        if total_pairs:
            self.host_expansions += 1
        kept_rows, kept_combo = [], []
        for c in range(host.shape[1] - 1):
            lo, hi = int(host[0, c]), int(host[0, c + 1])
            rows, combo = self._pairs(
                pi[lo:hi], qi[lo:hi], starts[lo:hi], counts[lo:hi],
                int(host[1, c + 1] - host[1, c]), q_cat, q0, qq, qh, eps, live_mask,
            )
            kept_rows.append(rows % st.emb_cat.shape[1])
            kept_combo.append(combo)
        rows_all = torch.cat(kept_rows) if kept_rows else empty
        combo_all = torch.cat(kept_combo) if kept_combo else empty
        # one read-back: kept rows per (slot, query), pairs per slot, stats
        with obs_trace.host_sync(2 if combo_all.numel() else 0):  # bincount reads min and max
            combo_counts = torch.bincount(combo_all, minlength=S * Q)
        small = [combo_counts,
                 torch.zeros(S, dtype=torch.int64, device=dev).index_add_(0, pi, counts)]
        if return_stats:
            small.append(self._stats(alive, gkeep, checked, pi, qi, counts).flatten())
        with obs_trace.host_sync():
            small = torch.cat(small).cpu().numpy()
        per_combo, slot_lp = small[: S * Q], small[S * Q : S * Q + S]
        self.part_leaf_pairs += slot_lp[st.slot_of]
        offs = np.concatenate([[0], np.cumsum(per_combo)])
        results = []
        for i in range(n_parts):
            base = int(st.slot_of[i]) * Q
            results.append(
                [
                    rows_all[offs[c] : offs[c + 1]] if per_combo[c] else empty
                    for c in range(base, base + Q)
                ]
            )
        if not return_stats:
            return results
        return results, self._stats_dicts(small[S * Q + S :].reshape(S, Q, -1), use_groups)

    # ------------------------------------------------------------------
    # the hand-off to the device join: candidate vertices per probe
    # ------------------------------------------------------------------
    def probe_device(
        self,
        q_emb: torch.Tensor,  # (n_parts, Q, D)
        q_emb0: torch.Tensor,  # (n_parts, Q, D0)
        q_multi: torch.Tensor | None = None,  # (n_gnn, n_parts, Q, D)
        q_label_hash: torch.Tensor | None = None,  # (Q,) int64, shared
        eps: float = 1e-6,
        use_groups: bool = False,
        return_stats: bool = False,
        live_mask: torch.Tensor | None = None,  # (S, P_max) bool; None: all live
    ):
        """Device-resident candidates of Q probes for the device join.

        Returns ``(per_probe, part_counts[, stats])``:

          * ``per_probe[b]``: the (n_b, L) int32 device tensor of probe b's
            candidate path vertices, the kept rows of every partition
            concatenated in slot order (``stacked.slot_of``), each
            partition's in ``probe``'s row order, less the rows
            ``live_mask`` marks dead;
          * ``part_counts`` (host, (n_parts, Q) int64): probe b's kept rows
            in engine partition ``i``;
          * ``stats``: ``probe``'s per-partition per-query dicts.

        The cells, the pairs and K1's verdicts stay on the device; the
        probe-major compaction is a ``bincount``, ``cumsum``s and one
        ``index_put_``.  Two small tensors come back to the host.  Where the
        pairs exceed ``leaf_pair_cap`` it falls back to ``probe``'s chunked
        leaf stage and concatenates each probe's rows in engine order (the
        JAX package's two orders); the candidate sets are the same.
        """
        st = self.stacked
        dev = st.device
        n_parts, Q = q_emb.shape[:2]
        self._check(n_parts, use_groups)
        paths = self._leaf_tensors()
        L = paths.shape[2]
        empty = torch.zeros((0, L), dtype=torch.int32, device=dev)
        if Q == 0 or self._total_paths == 0:
            out = ([empty] * Q, np.zeros((n_parts, Q), np.int64))
            return out + (self._zero_stats(n_parts, Q, use_groups),) if return_stats else out
        S = st.n_slots
        q_cat, q0 = self._slot_queries(q_emb, q_emb0, q_multi)
        with obs_trace.span("probe.descent", device=dev):
            alive, gkeep = self._device_masks(q_cat, q0, eps, "batched", use_groups)
        pi, qi, starts, counts = self._cells(alive, gkeep)
        checked = self._checked_groups(alive) if use_groups else None
        slot_lp = torch.zeros(S, dtype=torch.int64, device=dev).index_add_(0, pi, counts)
        with obs_trace.host_sync():
            head = torch.cat([slot_lp, self._group_pairs(checked)]).cpu().numpy()  # no pairs
        total = int(head[:S].sum())
        if total > self.leaf_pair_cap:
            # a fan-out past the cap: probe's chunked leaf stage (which
            # keeps the counters itself), then one gather per probe
            return self._probe_device_fallback(
                q_emb, q_emb0, q_multi, q_label_hash, eps, use_groups, return_stats, live_mask
            )
        index_mod._LEAF_PAIRS.inc(total)
        index_mod._GROUP_PAIRS.inc(int(head[S]))
        self.part_leaf_pairs += head[:S][st.slot_of]
        combo_counts = torch.zeros(S * Q, dtype=torch.int64, device=dev)
        out = empty
        if total:
            qq, qh = self._prefilter_queries(q_cat, q_label_hash, True)
            rows, combo = self._pairs(
                pi, qi, starts, counts, total, q_cat, q0, qq, qh, eps, live_mask
            )
            # probe-major compaction without a sort: the kept pairs come
            # (slot, probe)-major, so a pair's place is its probe's offset,
            # plus the kept pairs of its probe in earlier slots, plus its rank
            # within its own (slot, probe) run
            with obs_trace.host_sync(2 if combo.numel() else 0):  # bincount reads min and max
                combo_counts = torch.bincount(combo, minlength=S * Q)
            per_sb = combo_counts.view(S, Q)
            per_b = per_sb.sum(dim=0)
            base_sb = (torch.cumsum(per_b, 0) - per_b)[None, :] + torch.cumsum(per_sb, 0) - per_sb
            run_start = torch.cumsum(combo_counts, 0) - combo_counts
            pos = base_sb.flatten()[combo] + torch.arange(combo.numel(), device=dev) - run_start[combo]
            out = torch.empty((combo.numel(), L), dtype=torch.int32, device=dev)
            out.index_put_((pos,), paths.reshape(-1, L)[rows])
        small = [combo_counts]
        if return_stats:
            small.append(self._stats(alive, gkeep, checked, pi, qi, counts).flatten())
        with obs_trace.host_sync():
            small = torch.cat(small).cpu().numpy()
        cc = small[: S * Q].reshape(S, Q)
        per_probe = list(torch.split(out, cc.sum(axis=0).tolist())) if total else [empty] * Q
        part_counts = cc[st.slot_of]
        if not return_stats:
            return per_probe, part_counts
        return per_probe, part_counts, self._stats_dicts(small[S * Q :].reshape(S, Q, -1), use_groups)

    def _probe_device_fallback(
        self, q_emb, q_emb0, q_multi, q_label_hash, eps, use_groups, return_stats, live_mask
    ):
        """``probe``'s chunked leaf stage, then each probe's rows gathered
        partition by partition in engine order: the same candidates."""
        out = self.probe(
            q_emb, q_emb0, q_multi, q_label_hash=q_label_hash, eps=eps,
            use_groups=use_groups, return_stats=return_stats, live_mask=live_mask,
        )
        results, stats = out if return_stats else (out, None)
        n_parts, Q = q_emb.shape[:2]
        part_counts = np.asarray(
            [[int(r.numel()) for r in per_q] for per_q in results], np.int64
        ).reshape(n_parts, Q)
        per_probe = [
            torch.cat([ix.paths[results[i][b]] for i, ix in enumerate(self._indexes)]).to(
                torch.int32
            )
            for b in range(Q)
        ]
        if return_stats:
            return per_probe, part_counts, stats
        return per_probe, part_counts
