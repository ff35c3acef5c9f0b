"""K1's indexed forms and its native groups form on the CPU.

The port's engine hands K1 (``kernels/dominance_scan``) segments: int64
``rows`` and ``q_ids`` into tables the card's kernel reads in place.  Here
the plain versions of both verdicts (``dominance_scan_pairs_indexed_ref``,
``dominance_scan_groups_indexed_ref``) and the CPU wrappers are held bit for
bit against the JAX package's ``dominance_scan_pairs`` /
``dominance_scan_groups`` on the same gathered operands, through its plain
reference and its Pallas kernel in interpret mode: several segments, empty
ones and an all-empty call, the stacked (slot, row) indexing, ties at
exactly ±eps, NaN and ±inf, and widths other than the paper's 18 / 6.  The
descriptors that ``ops.segment_layout`` lays out for the card are checked by
reading every operand at the address the kernel would compute.  The CUDA
kernel itself is held against the plain versions on the card
(``test_torch_cuda.py``)."""
import bisect
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.dominance_scan.ops import dominance_scan_groups as jax_groups  # noqa: E402
from repro.kernels.dominance_scan.ops import dominance_scan_pairs as jax_pairs  # noqa: E402
from repro.kernels.dominance_scan.ref import dominance_scan_groups_ref as jax_groups_ref  # noqa: E402
from repro.kernels.dominance_scan.ref import dominance_scan_pairs_ref as jax_pairs_ref  # noqa: E402
from repro_torch.core import index as PI  # noqa: E402
from repro_torch.kernels.dominance_scan import ops  # noqa: E402
from repro_torch.kernels.dominance_scan.ref import (  # noqa: E402
    Segment,
    dominance_scan_groups_indexed_ref,
    dominance_scan_pairs_indexed_ref,
    gather_group_operands,
    gather_pair_operands,
    make_groups,
    make_segments,
)

EPS32 = np.float32(1e-6)


def _gathered(segs, groups: bool) -> list:
    """The segments' gathered operands, concatenated, as NumPy arrays."""
    gather = gather_group_operands if groups else gather_pair_operands
    parts = [gather(s) for s in segs]
    return [torch.cat([p[k] for p in parts]).numpy() for k in range(len(parts[0]))]


def _reference(segs, groups: bool, pallas: bool = True) -> np.ndarray:
    """The JAX package's verdict on the gathered operands: its plain
    reference, its wrapper's plain path and (``pallas``) its Pallas kernel in
    interpret mode, which must agree → bool (T,)."""
    arrs = _gathered(segs, groups)
    ref, wrap = (jax_groups_ref, jax_groups) if groups else (jax_pairs_ref, jax_pairs)
    want = np.asarray(ref(*arrs, eps=1e-6)).astype(bool)
    np.testing.assert_array_equal(np.asarray(wrap(*arrs, eps=1e-6, use_pallas=False)).astype(bool),
                                  want)
    if pallas and want.size:
        got = np.asarray(wrap(*arrs, eps=1e-6, interpret=True)).astype(bool)
        np.testing.assert_array_equal(got, want)
    return want


def _port(segs, groups: bool) -> np.ndarray:
    """The port's CPU wrapper and plain version, which must agree and launch
    nothing → bool (T,)."""
    wrap = ops.dominance_scan_groups_indexed if groups else ops.dominance_scan_pairs_indexed
    plain = dominance_scan_groups_indexed_ref if groups else dominance_scan_pairs_indexed_ref
    before = ops.LAUNCHES
    got = wrap(segs)
    assert ops.LAUNCHES == before, "no kernel launch may be counted for CPU tensors"
    assert got.dtype == torch.bool and got.shape == (sum(s.rows.numel() for s in segs),)
    assert torch.equal(got, plain(segs))
    return got.numpy()


def _emulate(segs, groups: bool, eps: float = 1e-6) -> np.ndarray:
    """The card kernel's verdicts from ``ops.segment_layout``'s descriptor:
    each pair's segment by the same search, and every operand read at the
    byte address the kernel computes from the descriptor's bases and
    strides, in float32 arithmetic."""
    L = ops.segment_layout(segs, groups)
    n, words = L.n_seg, L.words
    starts, fields = words[: n + 1], words[n + 1:]
    assert starts[-1] == L.T and len(fields) == 16 * n
    e = np.float32(eps)

    def f32(addr):
        return np.float32(ctypes.c_float.from_address(addr).value)

    def row(side, k, i):
        t0, rs0, t1, ts, rs1 = side[:5]
        return t0 + 4 * i * rs0 if k == 0 else t1 + 4 * ((k - 1) * ts + i * rs1)

    out = np.zeros(L.T, bool)
    with np.errstate(invalid="ignore"):
        for t in range(L.T):
            s = bisect.bisect_right(starts, t, 0, n) - 1
            f = fields[16 * s: 16 * s + 16]
            r = ctypes.c_int64.from_address(f[0] + 8 * (t - starts[s])).value
            q = ctypes.c_int64.from_address(f[1] + 8 * (t - starts[s])).value
            es, qs = f[2:9], f[9:16]
            keep = True
            for k in range(L.tables):
                for c in range(L.width):
                    keep &= bool(f32(row(qs, k, q) + 4 * c) <= f32(row(es, k, r) + 4 * c) + e)
            for j in range(L.labels):
                q0 = f32(qs[5] + 4 * (q * qs[6] + j))
                if groups:
                    lo = f32(es[5] + 4 * (r * es[6] + 2 * j))
                    hi = f32(es[5] + 4 * (r * es[6] + 2 * j + 1))
                    keep &= bool(q0 <= hi + e) and bool(q0 >= lo - e)
                else:
                    keep &= bool(abs(f32(es[5] + 4 * (r * es[6] + j)) - q0) <= e)
            out[t] = keep
    return out


@pytest.mark.parametrize("T,n_seg", [(0, 3), (1, 1), (37, 5), (1037, 4)])
@pytest.mark.parametrize("views", [False, True])
@pytest.mark.parametrize("groups", [False, True])
def test_indexed_plain_versions_bit_equal_to_reference(T, n_seg, views, groups):
    """Several segments (the second empty; at T = 0 all empty), each over its
    own shuffled tables: separate o(p), o'(p) tensors or column views of one
    table, the groups' (lo0, hi0) bounds interleaved."""
    segs = make_segments(T, seed=T + 3 * n_seg + views, n_seg=n_seg, groups=groups, views=views)
    assert len(segs) == n_seg and (n_seg < 3 or segs[1].rows.numel() == 0)
    want = _reference(segs, groups)
    np.testing.assert_array_equal(_port(segs, groups), want)
    if T > 100:
        assert 0 < want.sum() < T


@pytest.mark.parametrize("W,N,D0", [(6, 1, 6), (5, 2, 3), (8, 2, 4), (16, 1, 1), (3, 4, 2)])
@pytest.mark.parametrize("groups", [False, True])
def test_indexed_other_widths(W, N, D0, groups):
    """Widths the card takes at run time: one table, odd widths (4-byte
    loads), many tables, no label column."""
    segs = make_segments(300, seed=W * N + D0, W=W, N=N, D0=D0, n_seg=3, groups=groups)
    L = ops.segment_layout(segs, groups)
    assert (L.width, L.tables, L.labels) == (W, N, D0)
    np.testing.assert_array_equal(_port(segs, groups), _reference(segs, groups))


def _tie_segment(q_rows, q0_rows, e_rows, e0_rows, groups: bool) -> Segment:
    """One segment over the given rows, pair i naming data row i and query
    row i, the dominance columns as three tables of 2."""
    def side(dom, lab):
        t = torch.from_numpy(np.asarray(dom, np.float32))
        return (*t.split(2, dim=1), torch.from_numpy(np.asarray(lab, np.float32)))

    ids = torch.arange(len(q_rows))
    return Segment(ids, ids.clone(), side(e_rows, e0_rows), side(q_rows, q0_rows))


def test_ties_nan_and_inf_decide_as_the_reference():
    """Exactly at e + eps, |e0 − q0| = eps, lo0 − eps and hi0 + eps (kept), one
    ulp past each (dismissed), NaN anywhere (dismissed) and ±inf."""
    e = np.float32([0.5, 0.25, 0.125, 0.0625, 0.75, 1.0])
    up = lambda x: np.nextafter(np.float32(x), np.float32(np.inf))  # noqa: E731
    down = lambda x: np.nextafter(np.float32(x), np.float32(-np.inf))  # noqa: E731
    tie = (e + EPS32).astype(np.float32)
    lab = np.float32([0, 0.5])  # |0 - q0| = eps exactly at q0 = ±eps
    cases = [  # (q row, q0 row, e row, e0 row, kept)
        (tie, lab, e, lab, True),
        (np.where(np.arange(6) == 3, up(tie[3]), tie), lab, e, lab, False),
        (np.where(np.arange(6) == 3, down(tie[3]), tie), lab, e, lab, True),
        (e, np.float32([EPS32, 0.5]), e, lab, True),
        (e, np.float32([-EPS32, 0.5]), e, lab, True),
        (e, np.float32([up(EPS32), 0.5]), e, lab, False),
        (e, np.float32([down(-EPS32), 0.5]), e, lab, False),
        (np.where(np.arange(6) == 0, np.nan, e), lab, e, lab, False),
        (e, np.float32([np.nan, 0.5]), e, lab, False),
        (np.full(6, np.inf, np.float32), lab, e, lab, False),
        (e, lab, np.full(6, np.inf, np.float32), lab, True),
        (np.full(6, -np.inf, np.float32), lab, np.full(6, -np.inf, np.float32), lab, True),
        (e, np.float32([np.inf, 0.5]), e, np.float32([np.inf, 0.5]), False),  # inf - inf
    ]
    seg = _tie_segment(*[[c[k] for c in cases] for k in range(4)], groups=False)
    want = np.array([c[4] for c in cases])
    np.testing.assert_array_equal(_reference([seg], False), want)
    np.testing.assert_array_equal(_port([seg], False), want)
    np.testing.assert_array_equal(_emulate([seg], False), want)
    lo, hi = np.float32([0.25, 0.25]), np.float32([0.5, 0.75])
    at_lo, at_hi = (lo - EPS32).astype(np.float32), (hi + EPS32).astype(np.float32)
    gcases = [  # (q row, q0 row, hi row, (lo0, hi0), kept)
        (tie, at_lo, e, (lo, hi), True),
        (tie, at_hi, e, (lo, hi), True),
        (tie, down(at_lo[0]) * np.float32([1, 0]) + at_lo * np.float32([0, 1]), e, (lo, hi), False),
        (tie, up(at_hi[1]) * np.float32([0, 1]) + at_hi * np.float32([1, 0]), e, (lo, hi), False),
        (np.where(np.arange(6) == 5, up(tie[5]), tie), lo, e, (lo, hi), False),
        (tie, np.float32([np.nan, 0.3]), e, (lo, hi), False),
        (tie, np.float32([-1e30, 0.3]), e, (np.float32([-np.inf, 0.25]), hi), True),
        (tie, np.float32([0.3, 0.3]), e, (lo, np.float32([np.nan, 0.75])), False),
    ]
    bounds = [np.stack(c[3], axis=-1) for c in gcases]
    seg = _tie_segment([c[0] for c in gcases], [c[1] for c in gcases], [c[2] for c in gcases],
                       bounds, groups=True)
    want = np.array([c[4] for c in gcases])
    np.testing.assert_array_equal(_reference([seg], True), want)
    np.testing.assert_array_equal(_port([seg], True), want)
    np.testing.assert_array_equal(_emulate([seg], True), want)


def _stacked(seed: int, S: int = 4, P: int = 160, Q: int = 150, T: int = 400):
    """A stacked layout (S slots of P rows and Q queries) and T (slot, row,
    query) pairs, ``make_pairs``' rows planted at distinct positions of each
    slot and a quarter of the pairs re-using earlier pairs' data rows."""
    from repro_torch.kernels.dominance_scan.ref import make_pairs

    rng = np.random.default_rng(seed)
    qg, q0g, eg, e0g = make_pairs(T, seed=seed)
    emb = rng.random((S, P, 18), dtype=np.float32)
    emb0 = rng.random((S, P, 6), dtype=np.float32)
    qc = rng.random((S, Q, 18), dtype=np.float32)
    q0 = rng.random((S, Q, 6), dtype=np.float32)
    pr = rng.integers(0, S, T)
    rows, qr = np.zeros(T, np.int64), np.zeros(T, np.int64)
    for s in range(S):
        at = np.flatnonzero(pr == s)
        rows[at] = rng.permutation(P)[: at.size]
        qr[at] = rng.permutation(Q)[: at.size]
        emb[s, rows[at]], emb0[s, rows[at]] = eg[at], e0g[at]
        qc[s, qr[at]], q0[s, qr[at]] = qg[at], q0g[at]
    again = rng.random(T) < 0.25
    src = rng.integers(0, T, T)
    pr[again], rows[again] = pr[src[again]], rows[src[again]]
    return [torch.from_numpy(a) for a in (emb, emb0, qc, q0, pr, rows, qr)]


def test_stacked_slot_row_indexing():
    """The stacked probe's segment: flat rows slot·P_max + row and flat
    queries slot·Q + query into column views of the (S·P_max, 18) and (S·Q,
    18) tables, equal to the reference on the [slot, row] gathers."""
    emb, emb0, qc, q0, pr, rows, qr = _stacked(seed=5)
    S, P, Q = emb.shape[0], emb.shape[1], qc.shape[1]
    seg = Segment(pr * P + rows, pr * Q + qr,
                  (*emb.reshape(S * P, 18).split(6, dim=1), emb0.reshape(S * P, 6)),
                  (*qc.reshape(S * Q, 18).split(6, dim=1), q0.reshape(S * Q, 6)))
    arrs = [qc[pr, qr], q0[pr, qr], emb[pr, rows], emb0[pr, rows]]
    want = np.asarray(jax_pairs_ref(*[a.numpy() for a in arrs], eps=1e-6)).astype(bool)
    assert 0 < want.sum() < want.size
    np.testing.assert_array_equal(_reference([seg], False), want)
    np.testing.assert_array_equal(_port([seg], False), want)
    np.testing.assert_array_equal(_emulate([seg], False), want)
    L = ops.segment_layout([seg])
    assert (L.width, L.tables, L.labels, L.n_seg, L.vec) == (6, 3, 6, 1, True)
    assert L.words[2:9] == [seg.rows.data_ptr(), seg.q_ids.data_ptr(), emb.data_ptr(), 18,
                            emb.data_ptr() + 24, 6, 18]


def _at_offset(t: torch.Tensor, floats: int) -> torch.Tensor:
    """A copy of ``t`` whose data start ``floats`` floats into a fresh
    allocation, with ``t``'s shape and contiguous strides."""
    buf = torch.empty(t.numel() + floats, dtype=t.dtype)
    buf[floats:] = t.reshape(-1)
    return buf[floats:].view(t.shape)


@pytest.mark.parametrize("floats,vec", [(0, True), (1, False), (2, True)])
@pytest.mark.parametrize("groups", [False, True])
def test_descriptors_address_the_tables(floats, vec, groups):
    """``segment_layout``'s descriptor, read as the kernel reads it, gives
    the plain versions' verdicts, with bases 0, 4 and 8 bytes past an
    allocation (8-byte loads only where every base allows them) and more
    segments than a block keeps in shared memory."""
    segs = make_segments(1500, seed=floats + 10 * groups, n_seg=150, groups=groups)
    segs = [Segment(s.rows, s.q_ids, tuple(_at_offset(t, floats) for t in s.data),
                    tuple(_at_offset(t, floats) for t in s.query)) for s in segs]
    L = ops.segment_layout(segs, groups)
    assert L.vec is vec and L.n_seg == sum(s.rows.numel() > 0 for s in segs) > 128
    np.testing.assert_array_equal(_emulate(segs, groups), _port(segs, groups))
    np.testing.assert_array_equal(_port(segs, groups), _reference(segs, groups, pallas=False))


def test_segment_layout_rejects_what_the_kernel_does_not_take():
    seg = make_segments(50, seed=1, n_seg=1)[0]
    data, query = seg.data, seg.query
    bad = [
        (TypeError, Segment(seg.rows.int(), seg.q_ids, data, query)),
        (ValueError, Segment(seg.rows[:-1], seg.q_ids, data, query)),
        (ValueError, Segment(seg.rows[::2], seg.q_ids[::2], data, query)),
        (TypeError, Segment(seg.rows, seg.q_ids, (data[0].double(), *data[1:]), query)),
        (ValueError, Segment(seg.rows, seg.q_ids, (data[0].t().contiguous().t(), *data[1:]),
                             query)),
        (ValueError, Segment(seg.rows, seg.q_ids, (data[0][:, :5], *data[1:]), query)),
        (ValueError, Segment(seg.rows, seg.q_ids, data[1:], query)),  # 2 tables against 3
        (ValueError, Segment(seg.rows, seg.q_ids, (data[3],), query)),
        (ValueError, Segment(seg.rows, seg.q_ids, data, (*query[:-1], query[-1][:, :5]))),
    ]
    for exc, s in bad:
        with pytest.raises(exc):
            ops.dominance_scan_pairs_indexed([s])
    with pytest.raises(ValueError):
        ops.dominance_scan_pairs_indexed([])
    seg4 = make_segments(50, seed=1, n_seg=1, N=4)[0]  # tables 1, 2, 3 not one stride apart
    d = seg4.data
    with pytest.raises(ValueError):
        ops.dominance_scan_pairs_indexed([Segment(seg4.rows, seg4.q_ids,
                                                  (d[0], d[1], d[2].clone(), d[3], d[4]),
                                                  seg4.query)])
    ops.dominance_scan_pairs_indexed([seg4])
    with pytest.raises(ValueError):  # pairs labels where the groups verdict needs bounds
        ops.dominance_scan_groups_indexed([seg])
    groups_seg = make_segments(50, seed=2, n_seg=1, groups=True)[0]
    with pytest.raises(ValueError):
        ops.dominance_scan_pairs_indexed([groups_seg])


@pytest.mark.parametrize("D,D0", [(18, 6), (6, 6), (5, 3), (40, 9)])
def test_native_groups_form_bit_equal_to_reference(D, D0):
    """The packed groups form decides natively (one launch on the card, no
    concatenation); on the CPU its plain path equals the JAX package's
    concatenated form, through its plain reference and in interpret mode."""
    arrs = make_groups(517, seed=D + D0, D=D, D0=D0)
    want = np.asarray(jax_groups_ref(*arrs, eps=1e-6)).astype(bool)
    np.testing.assert_array_equal(np.asarray(jax_groups(*arrs, eps=1e-6, interpret=True))
                                  .astype(bool), want)
    before = ops.LAUNCHES
    got = ops.dominance_scan_groups(*[torch.from_numpy(a) for a in arrs])
    assert ops.LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


def test_the_loop_probe_hands_k1_its_tables_in_place():
    """Both probe levels of a grouped index hand K1 one list of segments a
    call, whose tables are the index's and the queries' own tensors (no
    operand gathered or concatenated first), and the verdicts equal the
    plain versions on them."""
    from repro_torch.core import GnnPeConfig, GnnPeEngine
    from repro_torch.graphs import newman_watts_strogatz, random_connected_query

    g = newman_watts_strogatz(300, k=4, p=0.15, n_labels=4, seed=3)
    eng = GnnPeEngine(GnnPeConfig(n_partitions=3, encoder="monotone", n_multi=2,
                                  index_kind="grouped", group_size=8), device="cpu").build(g)
    qs = [random_connected_query(g, 5, seed=s) for s in range(3)]
    seen = []
    saved = PI._groups_keep_mask, PI._pairs_keep_mask
    PI._groups_keep_mask = lambda *a: seen.append(("groups", a)) or saved[0](*a)
    PI._pairs_keep_mask = lambda *a: seen.append(("pairs", a)) or saved[1](*a)
    try:
        got = eng.match_many(qs)
    finally:
        PI._groups_keep_mask, PI._pairs_keep_mask = saved
    assert [k for k, _ in seen] == ["groups", "pairs"] and sum(map(len, got)) > 0
    tables = {t.data_ptr() for m in eng.models for t in (m.index.emb, m.index.emb0, *m.index.emb_multi,
                                                           m.index.groups.mbr_hi, m.index.groups.mbr0)}
    for kind, (segs, eps) in seen:
        assert segs and all(isinstance(s, Segment) for s in segs)
        assert {t.data_ptr() for s in segs for t in s.data[:1] + s.data[-1:]} <= tables
        plain = dominance_scan_groups_indexed_ref if kind == "groups" else dominance_scan_pairs_indexed_ref
        want = _reference(segs, kind == "groups", pallas=False)
        np.testing.assert_array_equal(plain(segs, eps).numpy(), want)
