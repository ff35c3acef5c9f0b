"""The stacked index probe on one device: one batched descent over every
partition's stacked tensors, then one leaf stage across all of them.

``core/stacked.py`` lays every partition's packed forest into dense
(S, …) tensors; this module runs the online filter over them:

  1. **device stage**: the level-synchronous MBR descent (Lemmas 4.3 and
     4.4) as batched tensor ops over the leading slot dimension, with no
     Python loop over partitions.  Queries go in chunks so that no
     intermediate exceeds ``_MASK_BUDGET`` bytes.  ``device_stage="numpy"``
     runs the plain ``stacked_masks_ref`` instead (the JAX package's name
     for the same switch);
  2. **leaf stage**: the surviving (slot, query, block) cells expand to
     (query, row) pairs on the device (``repeat_interleave`` over a
     ``cumsum``), in chunks of about ``leaf_pair_cap`` pairs, each through
     the conservative int8 + label-hash prefilter and then one fused
     verdict, ``index._pairs_keep_mask``: the kernel K1 on the card, its
     plain version on the CPU.

The rows per (partition, query) equal ``query_index_batch_multi``'s over
the source indexes, in the same order.  A probe call reads a few small
tensors back to the host, not one per partition.  ``probe_device`` (the
device-resident hand-off to the device join, ROADMAP queue 1 item 11),
``update_slot`` (item 12) and the multi-device mesh (item 15) are not
ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import index as index_mod
from ..core.index import _eps, quantize_query
from ..core.stacked import _GROUPED, build_stacked, stacked_masks_ref

__all__ = ["StackedProbe"]

_MASK_BUDGET = 256 << 20  # bytes of the largest descent intermediate


class StackedProbe:
    """Runs the probe over a ``StackedIndex`` built from ``indexes`` on
    their device (see the module doc).

    ``leaf_pair_cap`` bounds the cross-partition leaf expansion: the
    surviving cells expand in chunks of about ``cap`` (query, row) pairs,
    each through the prefilter and one fused verdict before the next
    exists.  The rows are the same for any cap.
    """

    def __init__(self, indexes: list, leaf_pair_cap: int = 1 << 21):
        if leaf_pair_cap < 1:
            raise ValueError(f"leaf_pair_cap must be >= 1, got {leaf_pair_cap}")
        self.leaf_pair_cap = int(leaf_pair_cap)
        self.stacked = build_stacked(indexes)
        st = self.stacked
        self._slot_of = torch.as_tensor(st.slot_of, device=st.device)
        self._total_paths = int(st.n_paths.sum())
        # per-partition (query, row) leaf pairs scanned, engine order,
        # cumulative over the probe's lifetime like the pair counter
        self.part_leaf_pairs = np.zeros(st.n_parts, np.int64)

    # ------------------------------------------------------------------
    # device stage: the batched dense descent
    # ------------------------------------------------------------------
    def _device_masks(self, q_cat, q0, eps: float, device_stage: str) -> torch.Tensor:
        """(S, Q, Dcat/D0) query tensors → (S, Q, B_leaf) leaf-block survival."""
        if device_stage == "numpy":
            return stacked_masks_ref(self.stacked, q_cat, q0, eps)[0]
        if device_stage != "batched":
            raise ValueError(f"unknown device_stage {device_stage!r}; use 'batched' or 'numpy'")
        st = self.stacked
        e = _eps(eps, st.device)
        # bounds widened once a call: the float32 ``bound ± eps`` the compares need
        levels = [
            ((hi + e)[:, None], (hi0 + e)[:, None], (lo0 - e)[:, None])
            for hi, lo0, hi0 in zip(st.level_hi, st.level_lo0, st.level_hi0)
        ]
        S, Q = q_cat.shape[:2]
        widest = max(hi.shape[2] for hi, _, _ in levels) * max(q_cat.shape[2], q0.shape[2])
        qc = max(1, _MASK_BUDGET // max(S * widest, 1))
        out = []
        for a in range(0, Q, qc):
            qa = q_cat[:, a : a + qc, None, :]
            q0a = q0[:, a : a + qc, None, :]
            alive = None
            for hi_e, hi0_e, lo0_e in levels:
                m = (qa <= hi_e).all(dim=-1)
                m &= (q0a <= hi0_e).all(dim=-1)
                m &= (q0a >= lo0_e).all(dim=-1)
                if alive is not None:
                    m &= alive.repeat_interleave(st.fanout, dim=2)[:, :, : m.shape[2]]
                alive = m
            out.append(alive)
        return out[0] if len(out) == 1 else torch.cat(out, dim=1)

    # ------------------------------------------------------------------
    # full probe: device masks → cross-partition leaf stage
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
    ):
        """Candidate rows for Q query paths against every partition.

        Returns a list (per partition, engine order) of lists (per query)
        of int64 row tensors: the rows, in the order, of
        ``query_index_batch_multi`` over the source indexes.  The leaf
        pairs scanned add to ``part_leaf_pairs``.
        """
        if use_groups:
            raise NotImplementedError(_GROUPED)
        st = self.stacked
        dev = st.device
        n_parts, Q = q_emb.shape[:2]
        if n_parts != st.n_parts:
            raise ValueError(f"expected {st.n_parts} partitions, got {n_parts}")
        empty = torch.zeros((0,), dtype=torch.int64, device=dev)
        if Q == 0 or self._total_paths == 0:
            return [[empty] * Q for _ in range(n_parts)]
        S, bs = st.n_slots, st.block_size
        # engine-order queries scattered into their slots (filler slots: 0⃗)
        cat = torch.cat([q_emb, *q_multi], dim=2) if st.n_gnn else q_emb
        q_cat = cat.new_zeros((S, Q, cat.shape[2]))
        q0 = q_emb0.new_zeros((S, Q, q_emb0.shape[2]))
        q_cat[self._slot_of] = cat
        q0[self._slot_of] = q_emb0
        alive = self._device_masks(q_cat, q0, eps, device_stage)

        # ---- leaf stage: (slot, query, block) cells → (query, row) pairs --
        # nonzero's row-major order makes the cells (slot, query)-major, so
        # the kept rows come out grouped by (slot, query) for the split
        pi, qi, bi = torch.nonzero(alive, as_tuple=True)
        starts = bi * bs
        counts = torch.clamp(st.n_paths[pi] - starts, 0, bs)
        ends = torch.cumsum(counts, 0)
        cell_start = ends - counts
        n_cells = int(pi.numel())
        # chunks are contiguous cell ranges: a cell joins chunk
        # cell_start // leaf_pair_cap, as in the JAX package; one read-back
        # gives every chunk's first cell and first pair
        host = np.zeros((2, 1), np.int64)
        if n_cells:
            chunk_of = cell_start // self.leaf_pair_cap
            first = torch.ones(n_cells, dtype=torch.bool, device=dev)
            first[1:] = chunk_of[1:] != chunk_of[:-1]
            firsts = torch.nonzero(first).flatten()
            host = torch.stack([
                torch.cat([firsts, firsts.new_full((1,), n_cells)]),
                torch.cat([cell_start[firsts], ends[-1:]]),
            ]).cpu().numpy()
        total_pairs = int(host[1, -1])
        index_mod._LEAF_PAIRS.inc(total_pairs)
        qq = qh = None
        if total_pairs and st.emb_q is not None:
            qq = quantize_query(q_cat)
            if st.label_hash is not None and q_label_hash is not None:
                qh = q_label_hash.to(dev)
        kept_rows, kept_combo = [], []
        for c in range(host.shape[1] - 1):
            lo, hi = int(host[0, c]), int(host[0, c + 1])
            p_lo, n = int(host[1, c]), int(host[1, c + 1] - host[1, c])
            cnt = counts[lo:hi]
            rows = torch.repeat_interleave(starts[lo:hi], cnt, output_size=n)
            rows += torch.arange(n, device=dev) - torch.repeat_interleave(
                cell_start[lo:hi] - p_lo, cnt, output_size=n
            )
            pr = torch.repeat_interleave(pi[lo:hi], cnt, output_size=n)
            qr = torch.repeat_interleave(qi[lo:hi], cnt, output_size=n)
            if qq is not None:  # the conservative int8 + label-hash prefilter
                pre = (qq[pr, qr] <= st.emb_q[pr, rows]).all(dim=1)
                if qh is not None:
                    pre &= st.label_hash[pr, rows] == qh[qr]
                sel = torch.nonzero(pre).flatten()
                rows, pr, qr = rows[sel], pr[sel], qr[sel]
            # exact Lemma 4.1 + 4.2 verdicts: one fused pass per chunk
            keep = index_mod._pairs_keep_mask(
                q_cat[pr, qr], q0[pr, qr], st.emb_cat[pr, rows], st.emb0[pr, rows], eps
            )
            sel = torch.nonzero(keep).flatten()
            kept_rows.append(rows[sel])
            kept_combo.append(pr[sel] * Q + qr[sel])
        rows_all = torch.cat(kept_rows) if kept_rows else empty
        combo_all = torch.cat(kept_combo) if kept_combo else empty
        # one read-back: kept rows per (slot, query) and pairs per slot
        small = torch.cat([
            torch.bincount(combo_all, minlength=S * Q),
            torch.zeros(S, dtype=torch.int64, device=dev).index_add_(0, pi, counts),
        ]).cpu().numpy()
        per_combo, slot_lp = small[: S * Q], small[S * Q :]
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
        return results
