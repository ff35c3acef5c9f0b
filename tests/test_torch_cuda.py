"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a card these tests skip (a CUDA kernel has no
CPU mode).  The file imports neither JAX nor the JAX package, so it runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.dominance_scan import ops  # noqa: E402
from repro_torch.kernels.dominance_scan.ref import (  # noqa: E402
    Segment,
    dominance_scan_batch_ref,
    dominance_scan_groups_indexed_ref,
    dominance_scan_groups_ref,
    dominance_scan_pairs_indexed_ref,
    dominance_scan_pairs_ref,
    dominance_scan_ref,
    make_groups,
    make_pairs,
    make_scan,
    make_segments,
)
from repro_torch.kernels.merge_join import ops as mj  # noqa: E402
from repro_torch.kernels.merge_join.ref import (  # noqa: E402
    injectivity_mask_ref,
    join_layouts,
    make_join_rows,
)
from repro_torch.kernels.star_agg import ops as sa  # noqa: E402
from repro_torch.kernels.star_agg.ref import make_bags, star_agg_ref  # noqa: E402
from repro_torch.kernels.cross_interact import ops as ci  # noqa: E402
from repro_torch.kernels.cross_interact.ref import cross_interact_ref, make_cross  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_scale,
    flash_attention_plain,
    k6_agreement,
    make_attn,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 1000, (1 << 20) + 7])
def test_dominance_scan_pairs_bit_equal_to_plain_version(cuda, T):
    args = [torch.from_numpy(a).to(cuda) for a in make_pairs(T, seed=T)]
    before = ops.LAUNCHES
    got = ops.dominance_scan_pairs(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    assert got.dtype == torch.bool and got.shape == (T,)
    assert torch.equal(got, dominance_scan_pairs_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("D,D0", [(6, 6), (18, 6), (40, 9), (300, 12)])
def test_dominance_scan_pairs_other_widths(cuda, D, D0):
    """Widths whose shared-memory tile is smaller or needs the opt-in size."""
    args = [torch.from_numpy(a).to(cuda) for a in make_pairs(4099, seed=D, D=D, D0=D0)]
    assert torch.equal(ops.dominance_scan_pairs(*args), dominance_scan_pairs_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 1000, (1 << 20) + 7])
@pytest.mark.parametrize("D,D0", [(18, 6), (6, 6)])
def test_dominance_scan_groups_bit_equal_to_plain_version(cuda, T, D, D0):
    """K1's packed groups form (one launch, the bounds read as they are)
    against the direct three compares, ties at every eps edge."""
    args = [torch.from_numpy(a).to(cuda) for a in make_groups(T, seed=T + D, D=D, D0=D0)]
    before = ops.LAUNCHES
    got = ops.dominance_scan_groups(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    assert torch.equal(got, dominance_scan_groups_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [5, 4097, 100_003])
@pytest.mark.parametrize("groups", [False, True])
def test_k1_packed_offset_bases(cuda, T, groups):
    """Packed operands 4 bytes past a 16-byte boundary (4-byte copies), T not a
    multiple of 4."""
    made = (make_groups if groups else make_pairs)(T, seed=T + groups)
    args = []
    for a in made:
        buf = torch.empty(a.size + 1, dtype=torch.float32, device=cuda)
        buf[1:] = torch.from_numpy(a).reshape(-1).to(cuda)
        args.append(buf[1:].view(a.shape))
    fn, plain = ((ops.dominance_scan_groups, dominance_scan_groups_ref) if groups
                 else (ops.dominance_scan_pairs, dominance_scan_pairs_ref))
    assert torch.equal(fn(*args), plain(*args))


@pytest.mark.cuda
def test_empty_batch_launches_nothing(cuda):
    args = [torch.from_numpy(a).to(cuda) for a in make_pairs(0, seed=0)]
    before = ops.LAUNCHES
    assert ops.dominance_scan_pairs(*args).shape == (0,)
    assert ops.LAUNCHES == before
    for groups in (False, True):
        segs = _on(make_segments(0, seed=0, n_seg=3, groups=groups), cuda)
        fn = ops.dominance_scan_groups_indexed if groups else ops.dominance_scan_pairs_indexed
        assert fn(segs).shape == (0,)
    assert ops.LAUNCHES == before


def _on(segs, dev, floats: int = 0) -> list:
    """``segs`` on ``dev``, every table starting ``floats`` floats into its
    own allocation."""
    def place(t):
        if not floats:
            return t.to(dev)
        buf = torch.empty(t.numel() + floats, dtype=t.dtype, device=dev)
        buf[floats:] = t.reshape(-1).to(dev)
        return buf[floats:].view(t.shape)

    return [Segment(s.rows.to(dev), s.q_ids.to(dev), tuple(map(place, s.data)),
                    tuple(map(place, s.query))) for s in segs]


def _indexed_equal(segs, groups: bool) -> torch.Tensor:
    """One K1 launch on ``segs`` against the plain version, bit for bit."""
    fn = ops.dominance_scan_groups_indexed if groups else ops.dominance_scan_pairs_indexed
    plain = dominance_scan_groups_indexed_ref if groups else dominance_scan_pairs_indexed_ref
    before = ops.LAUNCHES
    got = fn(segs)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    want = plain(segs)
    assert got.dtype == torch.bool and got.shape == want.shape
    assert torch.equal(got, want)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 1001, 4099, (1 << 20) + 7])
@pytest.mark.parametrize("views", [False, True])
@pytest.mark.parametrize("groups", [False, True])
def test_k1_indexed_bit_equal_to_plain_version(cuda, T, views, groups):
    """Both indexed verdicts at the paper's widths (T not a multiple of 4,
    an empty segment among five), on separate tables and on column views."""
    segs = _on(make_segments(T, seed=T + views, n_seg=5, groups=groups, views=views), cuda)
    assert ops.segment_layout(segs, groups).vec
    got = _indexed_equal(segs, groups)
    assert T < 100 or 0 < int(got.sum()) < T


@pytest.mark.cuda
@pytest.mark.parametrize("floats,vec", [(1, False), (2, True)])
@pytest.mark.parametrize("groups", [False, True])
def test_k1_indexed_offset_bases(cuda, floats, vec, groups):
    """Tables 4 bytes past an allocation (4-byte loads) and 8 bytes past
    (8-byte loads, off 16)."""
    segs = _on(make_segments(100_003, seed=floats, n_seg=7, groups=groups), cuda, floats)
    assert ops.segment_layout(segs, groups).vec is vec
    _indexed_equal(segs, groups)


@pytest.mark.cuda
@pytest.mark.parametrize("n_seg", [131, 300])
@pytest.mark.parametrize("groups", [False, True])
def test_k1_indexed_past_the_descriptor_capacity(cuda, n_seg, groups):
    """More segments than a block keeps in shared memory: the search and the
    descriptors read from device memory."""
    segs = _on(make_segments(200_003, seed=n_seg, n_seg=n_seg, groups=groups), cuda)
    assert ops.segment_layout(segs, groups).n_seg > 128
    _indexed_equal(segs, groups)


@pytest.mark.cuda
@pytest.mark.parametrize("W,N,D0", [(6, 1, 6), (5, 2, 3), (8, 2, 4), (16, 1, 1), (3, 4, 2)])
@pytest.mark.parametrize("groups", [False, True])
def test_k1_indexed_other_widths(cuda, W, N, D0, groups):
    """Widths read at run time (any other than the paper's 6 x 3, 6)."""
    segs = make_segments(40_001, seed=W + N, W=W, N=N, D0=D0, n_seg=4, groups=groups,
                         device=cuda)
    _indexed_equal(segs, groups)


@pytest.mark.cuda
def test_k1_indexed_offsets_past_two_gigabytes(cuda):
    """Rows of a 32 M-row table of 72-byte rows, whose byte offsets pass
    2^31, read through int64 indices; the queries are copies of some of
    those rows, so those pairs are kept."""
    R, T, Q = 32_000_000, 65_537, 1000
    g = torch.Generator(device=cuda).manual_seed(0)
    emb = torch.rand((R, 18), device=cuda, generator=g)
    emb0 = torch.floor(torch.rand((R, 6), device=cuda, generator=g) * 4)
    rows = R - 1 - torch.randint(0, 1_000_000, (T,), device=cuda, generator=g)
    assert int(rows.min()) * 72 > 2**31
    q_ids = torch.randint(0, Q, (T,), device=cuda, generator=g)
    q_ids[:Q] = torch.arange(Q, device=cuda)
    qc, q0 = emb[rows[:Q]].clone(), emb0[rows[:Q]].clone()
    seg = Segment(rows, q_ids, (*emb.split(6, dim=1), emb0), (*qc.split(6, dim=1), q0))
    got = _indexed_equal([seg], False)
    assert bool(got[:Q].all())
    del emb, emb0


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 1000, (1 << 20) + 7])
@pytest.mark.parametrize("Co,Cn", [(7, 1), (5, 2), (0, 3), (12, 8), (56, 8)])
def test_injectivity_mask_bit_equal_to_plain_version(cuda, T, Co, Cn):
    old, new = (torch.from_numpy(a).to(cuda) for a in make_join_rows(T, Co, Cn, seed=T + Co))
    before = mj.LAUNCHES
    got = mj.injectivity_mask(old, new)
    torch.cuda.synchronize()
    assert mj.LAUNCHES == before + 1
    assert got.dtype == torch.bool and got.shape == (T,)
    assert torch.equal(got, injectivity_mask_ref(old, new))


@pytest.mark.cuda
def test_injectivity_mask_strided_slices_and_limits(cuda):
    old, new = make_join_rows(5000, 6, 2, seed=1)
    table = torch.from_numpy(np.concatenate([old, new], 1)).to(cuda)
    got = mj.injectivity_mask(table[:, :6], table[:, 6:])
    assert torch.equal(got, injectivity_mask_ref(table[:, :6], table[:, 6:]))
    wide = torch.zeros((4, 9), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        mj.injectivity_mask(wide[:, :0], wide)  # more new columns than the kernel holds
    before = mj.LAUNCHES
    assert mj.injectivity_mask(table[:0, :6], table[:0, 6:]).shape == (0,)
    assert mj.injectivity_mask(table[:, :6], table[:, 6:6]).all()
    assert mj.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("T", [3, 4, 5, 4097, 524_293])
@pytest.mark.parametrize("Co,Cn", [(1, 1), (6, 1), (5, 2), (7, 1), (0, 8), (8, 8), (15, 1),
                                   (9, 8), (56, 8)])
def test_injectivity_mask_edge_shapes(cuda, T, Co, Cn):
    """T that is no multiple of the tile or of 4, W = 2 to 64, in every
    layout (one table, bases off 16 bytes, separate tensors, a wider parent
    table) and on rows of all sentinels: bit-equal to the plain version,
    each launch on the layout the wrapper gives it."""
    old, new = (torch.from_numpy(a).to(cuda) for a in make_join_rows(T, Co, Cn, seed=T + Co))
    want = injectivity_mask_ref(old, new)
    for what, (a, b, layout) in join_layouts(old, new).items():
        launches, contiguous = mj.LAUNCHES, mj.CONTIGUOUS_LAUNCHES
        got = mj.injectivity_mask(a, b)
        torch.cuda.synchronize()
        assert torch.equal(got, want), what
        assert mj.LAUNCHES == launches + 1
        assert mj.CONTIGUOUS_LAUNCHES == contiguous + (layout == "contiguous"), what
    s_old, s_new = (torch.from_numpy(a).to(cuda)
                    for a in make_join_rows(T, Co, Cn, seed=0, all_sentinels=True))
    assert mj.injectivity_mask(s_old, s_new).all()


@pytest.mark.cuda
def test_injectivity_mask_takes_the_contiguous_path(cuda):
    """The join's own operands (the column slices of one table) take the
    contiguous layout; separate tensors take the strided one."""
    old, new = (torch.from_numpy(a).to(cuda) for a in make_join_rows(5000, 6, 1, seed=3))
    flat = torch.cat([old, new], 1)
    contiguous = mj.CONTIGUOUS_LAUNCHES
    got = mj.injectivity_mask(flat[:, :6], flat[:, 6:])
    assert mj.CONTIGUOUS_LAUNCHES == contiguous + 1
    assert torch.equal(mj.injectivity_mask(old, new), got)
    assert mj.CONTIGUOUS_LAUNCHES == contiguous + 1
    assert torch.equal(got, injectivity_mask_ref(old, new))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 1000, (1 << 20) + 7])
@pytest.mark.parametrize("D,D0", [(18, 6), (5, 3), (300, 12)])
def test_dense_scan_single_bit_equal_to_plain_version(cuda, N, D, D0):
    q, q0, emb, emb0 = (torch.from_numpy(a).to(cuda) for a in make_scan(1, N, seed=N, D=D, D0=D0))
    before = ops.SINGLE_LAUNCHES
    got = ops.dominance_scan(q[0].contiguous(), q0[0].contiguous(), emb, emb0)
    torch.cuda.synchronize()
    assert ops.SINGLE_LAUNCHES == before + 1
    assert torch.equal(got, dominance_scan_ref(q[0], q0[0], emb, emb0))


@pytest.mark.cuda
@pytest.mark.parametrize("Q,N", [(1, 1), (7, 1000), (17, 4099), (64, (1 << 20) + 7)])
@pytest.mark.parametrize("D,D0", [(18, 6), (5, 3)])
def test_dense_scan_batch_bit_equal_to_plain_version(cuda, Q, N, D, D0):
    q, q0, emb, emb0 = (torch.from_numpy(a).to(cuda) for a in make_scan(Q, N, seed=Q + N, D=D, D0=D0))
    before = ops.BATCH_LAUNCHES
    got = ops.dominance_scan(q, q0, emb, emb0)
    torch.cuda.synchronize()
    assert ops.BATCH_LAUNCHES == before + 1
    assert got.shape == (Q, N)
    assert torch.equal(got, dominance_scan_batch_ref(q, q0, emb, emb0))


def _off_by_one_float(t):
    """A contiguous copy of ``t`` whose data start 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    out = buf[1:].view(t.shape)
    assert out.is_contiguous() and out.data_ptr() % 16 == 4
    return out


def _both_forms_bit_equal(q, q0, emb, emb0, rows=3):
    """K3-batch on all of q and K3-single on its first ``rows`` rows, each one
    launch and each bit-equal to its plain version → the batch verdict."""
    before = (ops.SINGLE_LAUNCHES, ops.BATCH_LAUNCHES)
    got = ops.dominance_scan(q, q0, emb, emb0)
    torch.cuda.synchronize()
    assert ops.BATCH_LAUNCHES == before[1] + 1
    assert got.dtype == torch.bool and got.shape == (q.shape[0], emb.shape[0])
    assert torch.equal(got, dominance_scan_batch_ref(q, q0, emb, emb0))
    for k in range(min(rows, q.shape[0])):
        qk, q0k = (_off_by_one_float(t[k]) if t.data_ptr() % 16 else t[k].contiguous()
                   for t in (q, q0))
        assert torch.equal(ops.dominance_scan(qk, q0k, emb, emb0),
                           dominance_scan_ref(qk, q0k, emb, emb0))
    assert ops.SINGLE_LAUNCHES == before[0] + min(rows, q.shape[0])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("Q,N,D,D0", [(17, 4099, 18, 6), (17, (1 << 20) + 7, 18, 6),
                                      (17, 4099, 5, 3), (3, 1037, 300, 12)])
def test_dense_scans_offset_base(cuda, Q, N, D, D0):
    """Operands that start one float past 16 bytes take the word copies."""
    arrs = make_scan(Q, N, seed=Q + N + D, D=D, D0=D0)
    args = [_off_by_one_float(torch.from_numpy(a).to(cuda)) for a in arrs]
    got = _both_forms_bit_equal(*args)
    aligned = [torch.from_numpy(a).to(cuda) for a in arrs]
    assert torch.equal(got, ops.dominance_scan(*aligned))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1037, 4099, 4097, 130])
def test_dense_scans_packed_store_edges(cuda, N):
    """Output rows that start off a 4-byte word (N % 4 != 0) and ragged ends."""
    q, q0, emb, emb0 = (torch.from_numpy(a).to(cuda) for a in make_scan(17, N, seed=N))
    got = _both_forms_bit_equal(q, q0, emb, emb0, rows=17)
    assert 0 < int(got.sum()) < got.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [649, 650, 3000])
def test_dense_scan_batch_query_tiles(cuda, Q):
    """More queries than shared memory holds at D = 18: the block walks query
    tiles (649 fit beside the lane slots) with its data tile in registers."""
    q, q0, emb, emb0 = (torch.from_numpy(a).to(cuda) for a in make_scan(Q, 4099, seed=Q))
    _both_forms_bit_equal(q, q0, emb, emb0)


@pytest.mark.cuda
@pytest.mark.parametrize("Q,N,D,D0", [(70, (1 << 20) + 7, 18, 6), (17, 4099, 5, 3)])
def test_dense_scans_all_labels_match(cuda, Q, N, D, D0):
    """Every row carries its partner query's labels, so no vote skips the
    dominance columns of a query its partner row meets."""
    arrs = make_scan(Q, N, seed=Q + N, D=D, D0=D0, match_labels=True)
    q, q0, emb, emb0 = (torch.from_numpy(a).to(cuda) for a in arrs)
    got = _both_forms_bit_equal(q, q0, emb, emb0)
    labels = dominance_scan_batch_ref(torch.full_like(q, -float("inf")), q0, emb, emb0)
    assert bool(labels.any(dim=0).all()) and int(got.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("Q,N", [(17, 4099), (2, 100_003), (700, 1037)])
def test_dense_scan_batch_wide_rows(cuda, Q, N):
    """D = 300, D0 = 12: 19 column chunks, each ANDed into the first one's
    output words; at Q = 700 with query tiles too.  Labels match, so that
    the +inf rows are kept."""
    q, q0, emb, emb0 = (torch.from_numpy(a).to(cuda)
                        for a in make_scan(Q, N, seed=Q + N, D=300, D0=12, match_labels=True))
    assert int(_both_forms_bit_equal(q, q0, emb, emb0).sum()) > 0


@pytest.mark.cuda
def test_dense_scans_empty_launch_nothing(cuda):
    q, q0, emb, emb0 = (torch.from_numpy(a).to(cuda) for a in make_scan(3, 0, seed=0))
    before = (ops.SINGLE_LAUNCHES, ops.BATCH_LAUNCHES)
    assert ops.dominance_scan(q, q0, emb, emb0).shape == (3, 0)
    assert ops.dominance_scan(q[0].contiguous(), q0[0].contiguous(), emb, emb0).shape == (0,)
    assert ops.dominance_scan(q[:0], q0[:0], emb, emb0).shape == (0, 0)
    assert (ops.SINGLE_LAUNCHES, ops.BATCH_LAUNCHES) == before


@pytest.mark.cuda
def test_device_join_on_the_card_equals_the_cpu(cuda):
    """The device join's match lists on the card equal the CPU's, and its
    injectivity verdicts went through K2."""
    from repro_torch.core import GnnPeConfig, GnnPeEngine
    from repro_torch.graphs import newman_watts_strogatz, random_connected_query

    g = newman_watts_strogatz(400, k=4, p=0.15, n_labels=4, seed=3)
    cfg = GnnPeConfig(n_partitions=3, encoder="monotone", join_impl="device")
    qs = [random_connected_query(g, 6, seed=s) for s in range(4)]
    want = GnnPeEngine(cfg, device="cpu").build(g).match_many(qs)
    before = mj.LAUNCHES
    got = GnnPeEngine(cfg, device=cuda).build(g).match_many(qs)
    assert mj.LAUNCHES > before
    assert got == want and sum(map(len, got)) > 0


@pytest.mark.cuda
def test_use_pallas_scan_on_the_card(cuda):
    """On the card None and True both take K1 and give the CPU's match
    lists; False, the plain verdict, is refused there."""
    from repro_torch.core import GnnPeConfig, GnnPeEngine
    from repro_torch.graphs import newman_watts_strogatz, random_connected_query

    g = newman_watts_strogatz(400, k=4, p=0.15, n_labels=4, seed=3)
    base = dict(n_partitions=3, encoder="monotone")
    qs = [random_connected_query(g, 6, seed=s) for s in range(4)]
    want = GnnPeEngine(GnnPeConfig(**base), device="cpu").build(g).match_many(qs)
    for value in (None, True):
        before = ops.LAUNCHES
        got = GnnPeEngine(GnnPeConfig(**base, use_pallas_scan=value), device=cuda).build(g).match_many(qs)
        assert ops.LAUNCHES > before
        assert got == want and sum(map(len, got)) > 0
    with pytest.raises(ValueError, match="runs only on the CPU"):
        GnnPeEngine(GnnPeConfig(**base, use_pallas_scan=False), device=cuda)


@pytest.mark.cuda
def test_stacked_probe_on_the_card_equals_the_loop(cuda):
    """The stacked probe on the card, with the int8 sidecar and dr plans:
    its verdicts went through K1, and its match lists equal the loop
    probe's and the CPU's, with both joins."""
    from repro_torch.core import GnnPeConfig, GnnPeEngine, sort_matches
    from repro_torch.core import index as index_mod
    from repro_torch.graphs import newman_watts_strogatz, random_connected_query

    g = newman_watts_strogatz(400, k=4, p=0.15, n_labels=4, seed=3)
    cfg = GnnPeConfig(n_partitions=3, encoder="monotone", quantize_index=True, plan_weight="dr",
                      probe_impl="stacked")
    qs = [random_connected_query(g, 6, seed=s) for s in range(4)]
    cpu = GnnPeEngine(cfg, device="cpu").build(g)
    eng = GnnPeEngine(cfg, device=cuda).build(g)
    assert eng.offline_stats["stacked_bytes"] == cpu.offline_stats["stacked_bytes"]
    for join in ("numpy", "device"):
        seen = []
        keep_mask = index_mod._pairs_keep_mask
        index_mod._pairs_keep_mask = lambda *a: seen.append(a) or keep_mask(*a)
        before = ops.LAUNCHES
        try:
            got = eng.match_many(qs, join_impl=join)
        finally:
            index_mod._pairs_keep_mask = keep_mask
        assert ops.LAUNCHES > before and seen
        for segs, eps in seen:
            assert torch.equal(ops.dominance_scan_pairs_indexed(segs, eps),
                               dominance_scan_pairs_indexed_ref(segs, eps))
        # the device join takes the stacked probe's hand-off, in slot order
        loop = eng.match_many(qs, probe_impl="loop", join_impl=join)
        assert [sort_matches(m) for m in got] == [sort_matches(m) for m in loop]
        assert got == cpu.match_many(qs, join_impl=join) and sum(map(len, got)) > 0
    for q, m in zip(qs[:2], cpu.match_many(qs[:2])):
        assert eng.match(q, impl="scalar") == m


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fixed", "auto"])
def test_grouped_engine_and_hand_off_on_the_card(cuda, mode):
    """A grouped engine on the card: its sidecar sizes equal the CPU's, the
    loop probe launches K1 for the group level and the member level, each
    verdict equal to its plain version, and every kind × probe × join
    gives the CPU's lists; the stacked probe's hand-off to the device join
    splits no rows per (partition, query)."""
    import itertools

    from repro_torch.core import GnnPeConfig, GnnPeEngine
    from repro_torch.core import index as index_mod
    from repro_torch.graphs import newman_watts_strogatz, random_connected_query

    g = newman_watts_strogatz(600, k=4, p=0.15, n_labels=4, seed=3)
    cfg = GnnPeConfig(n_partitions=5, encoder="monotone", index_kind="grouped",
                      group_size_mode=mode, plan_weight="dr")
    qs = [random_connected_query(g, 6, seed=s) for s in range(4)]
    cpu = GnnPeEngine(cfg, device="cpu").build(g)
    eng = GnnPeEngine(cfg, device=cuda).build(g)
    for key in ("n_groups", "group_sizes", "group_bytes"):
        assert eng.offline_stats[key] == cpu.offline_stats[key]
    seen = []
    saved = index_mod._groups_keep_mask, index_mod._pairs_keep_mask
    index_mod._groups_keep_mask = lambda *a: seen.append(("groups", a)) or saved[0](*a)
    index_mod._pairs_keep_mask = lambda *a: seen.append(("pairs", a)) or saved[1](*a)
    before = ops.LAUNCHES
    try:
        got = eng.match_many(qs, probe_impl="loop")
    finally:
        index_mod._groups_keep_mask, index_mod._pairs_keep_mask = saved
    assert ops.LAUNCHES >= before + 2 and {k for k, _ in seen} == {"groups", "pairs"}
    for kind, a in seen:
        fn, plain = ((ops.dominance_scan_groups_indexed, dominance_scan_groups_indexed_ref)
                     if kind == "groups"
                     else (ops.dominance_scan_pairs_indexed, dominance_scan_pairs_indexed_ref))
        assert torch.equal(fn(*a), plain(*a))
    assert got == cpu.match_many(qs, probe_impl="loop") and sum(map(len, got)) > 0
    for kind, probe, join in itertools.product(("path", "grouped"), ("loop", "stacked"),
                                               ("numpy", "device")):
        kw = dict(index_kind=kind, probe_impl=probe, join_impl=join)
        expansions = eng.stacked_probe().host_expansions
        assert eng.match_many(qs, **kw) == cpu.match_many(qs, **kw), kw
        if (probe, join) == ("stacked", "device"):
            assert eng.stacked_probe().host_expansions == expansions


@pytest.mark.cuda
def test_sidecar_on_the_card_equals_the_cpu(cuda):
    """emb_q and label_hash made on the card equal the quantizers and the
    hash of the CPU copies; the query side, hashed on the host, equals the
    card's hash of the same labels at a length where the hash wraps."""
    from repro_torch.core import GnnPeConfig, GnnPeEngine
    from repro_torch.core.index import hash_labels, quantize_data, quantize_query
    from repro_torch.graphs import newman_watts_strogatz

    g = newman_watts_strogatz(400, k=4, p=0.15, n_labels=4, seed=3)
    eng = GnnPeEngine(GnnPeConfig(n_partitions=3, encoder="monotone", quantize_index=True),
                      device=cuda).build(g)
    for m in eng.models:
        idx = m.index
        cat = torch.cat([idx.emb, *idx.emb_multi], dim=1).cpu()
        assert torch.equal(idx.emb_q.cpu(), quantize_data(cat))
        labels = torch.as_tensor(g.labels.astype(np.int64))[idx.paths.cpu()]
        assert torch.equal(idx.label_hash.cpu(), hash_labels(labels))
    rng = np.random.default_rng(0)
    lab = torch.as_tensor(rng.integers(0, 1 << 20, (10_000, 7)))
    assert torch.equal(hash_labels(lab.to(cuda)).cpu(), hash_labels(lab))
    x = torch.as_tensor(np.concatenate([np.arange(-2, 253) / 250.0, rng.random(10_000)]),
                        dtype=torch.float32)
    for fn in (quantize_data, quantize_query):
        assert torch.equal(fn(x.to(cuda)).cpu(), fn(x))


@pytest.mark.cuda
@pytest.mark.parametrize("N,K,V,E", [(1, 1, 7, 16), (4099, 1, 1000, 16), (1000, 8, 300, 16),
                                     (777, 3, 50, 6), (2048, 8, 64, 128)])
def test_star_agg_against_plain_version(cuda, N, K, V, E):
    """K = 1 bit-equal (a row copy); multi-hot with masked −1 / out-of-range
    ids and an all-masked row within float32 rounding of the plain sum."""
    idx, mask, table = make_bags(N, K, V, E, seed=N + K)
    if K == 1:
        mask[:] = True
        idx = np.random.default_rng(N).integers(0, V, (N, 1)).astype(np.int32)
    idx, mask, table = (torch.from_numpy(a).to(cuda) for a in (idx, mask, table))
    before = sa.LAUNCHES
    got = sa.star_agg(idx, mask, table)
    torch.cuda.synchronize()
    assert sa.LAUNCHES == before + 1
    assert got.shape == (N, E) and got.dtype == torch.float32
    if K == 1:
        assert torch.equal(got, table[idx[:, 0].long()])
    else:
        assert torch.equal(got[0], torch.zeros_like(got[0]))
        torch.testing.assert_close(got, star_agg_ref(idx, mask, table), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B,D,scale", [
    (1, 429, None), (1, 1, None), (513, 429, None), (300, 64, None), (1000, 130, None),
    # B across the 128-row tile; D across the 216-column tile and the 32-wide k slice
    (63, 429, None), (64, 429, None), (65, 429, None), (129, 429, None), (4099, 429, None),
    (513, 7, None), (513, 8, None), (513, 432, None),
    # non-negative operands, so that no output cancels: at 1e3 rtol governs.  These check
    # the scaling path, not the precision: on sums of positive terms one tf32 pass would
    # also pass them; the unscaled cases tell three passes from one
    (513, 429, 1e3), (513, 429, 1e-3),
])
def test_cross_interact_against_plain_version(cuda, B, D, scale):
    """Ragged B and D (429 divides no tile) within float32 rounding: the
    3xTF32 products keep rtol = atol = 1e-4."""
    arrs = make_cross(B, D, seed=B + D)
    if scale is not None:
        arrs = [np.abs(a) * np.float32(scale) for a in arrs]
    x0, x, w, b = (torch.from_numpy(a).to(cuda) for a in arrs)
    before = ci.LAUNCHES
    got = ci.cross_interact(x0, x, w, b)
    torch.cuda.synchronize()
    assert ci.LAUNCHES == before + 1
    torch.testing.assert_close(got, cross_interact_ref(x0, x, w, b), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_dcn_serve_on_the_card_equals_the_cpu(cuda):
    """The smoke DCN-v2 serve and retrieval steps on the card equal the CPU's,
    through one K4 launch and three K5 launches per forward."""
    from repro_torch.configs import build_step, get_arch, init_params, make_batch, resolve_config

    arch = get_arch("dcn-v2")
    for name in ("serve_p99", "retrieval_cand"):
        cell = arch.cell(name)
        cfg = resolve_config(arch, cell, smoke=True)
        params = init_params(arch, cfg, seed=0, device=cuda)
        cpu_params = {k: ([{n: t.cpu() for n, t in d.items()} for d in v] if isinstance(v, list)
                          else v.cpu()) for k, v in params.items()}
        step, _ = build_step(arch, cell, cfg)
        before = (sa.LAUNCHES, ci.LAUNCHES)
        got = step(params, make_batch(arch, cell, cfg, seed=1, device=cuda))
        torch.cuda.synchronize()
        assert (sa.LAUNCHES, ci.LAUNCHES) == (before[0] + 1, before[1] + 3)
        want = step(cpu_params, make_batch(arch, cell, cfg, seed=1, device="cpu"))
        if name == "serve_p99":
            torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
        else:
            torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-5, atol=1e-5)
            assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("S,dh,G", [(1, 64, 1), (127, 128, 4), (1000, 256, 4), (1000, 80, 2),
                                    (300, 16, 1), (64, 256, 4), (65, 256, 4), (129, 256, 1),
                                    (4097, 256, 4), (1000, 80, 4)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 100), (False, None), (False, 50),
                                           (True, 1)])
def test_flash_attention_against_plain_version(cuda, S, dh, G, causal, window):
    """Any S (the ragged tail masked; S at the edges of the 64-key tile and
    the 128-row block, where TMA zero-fills the tail), dh a multiple of 16 up
    to 256 (dh 80 zero-filled to 128 by TMA), GQA without a repeat copy, a
    window of one key, within ``ref.k6_agreement``'s tolerance (K6 feeds P to
    P·V in bf16)."""
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16)
               for a in make_attn(2, S, 2 * G, 2, dh, seed=S + dh))
    before = fa.LAUNCHES
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    res = k6_agreement(got, flash_attention_plain(q, k, v, causal, window),
                       attention_scale(q, k, v, causal, window))
    assert res["ok"], res


@pytest.mark.cuda
@pytest.mark.parametrize("S,Hq,Hkv,dh,dv", [(1000, 6, 2, 128, 128), (777, 12, 1, 128, 128),
                                          (300, 16, 1, 128, 128), (1000, 4, 4, 192, 128),
                                          (129, 2, 2, 24, 16), (65, 4, 1, 8, 8)])
def test_flash_attention_at_the_lm_family_shapes(cuda, S, Hq, Hkv, dh, dv):
    """G = 3, 12 and 16 (minitron, command-r, qwen3); MLA's q and k of 192
    with a v of 128, padded to 192 by the wrapper; the smoke MLA's 24 / 16
    and command-r's 8, padded to 32 and 16: one launch each, within
    ``ref.k6_agreement``'s tolerance, the output dv wide."""
    g = torch.Generator(device=cuda).manual_seed(S + Hq + dh)
    q, k = (torch.randn((2, S, h, dh), generator=g, device=cuda).to(torch.bfloat16)
            for h in (Hq, Hkv))
    v = torch.randn((2, S, Hkv, dv), generator=g, device=cuda).to(torch.bfloat16)
    before = fa.LAUNCHES
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1 and got.shape == (2, S, Hq, dv)
    res = k6_agreement(got, flash_attention_plain(q, k, v), attention_scale(q, k, v))
    assert res["ok"], res


@pytest.mark.cuda
def test_flash_attention_strided_operands_and_limits(cuda):
    qkv = torch.randn((2, 333, 8, 64), device=cuda).to(torch.bfloat16)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]  # head slices, no copy
    res = k6_agreement(fa.flash_attention(q, k, v, window=40),
                       flash_attention_plain(q, k, v, window=40),
                       attention_scale(q, k, v, window=40))
    assert res["ok"], res
    with pytest.raises(TypeError, match="bf16"):
        fa.flash_attention(q.float(), k.float(), v.float())
    # dh 24, off the kernel's multiples of 16: padded with zero columns, exact
    n24 = [t[..., :24] for t in (q, k, v)]
    res = k6_agreement(fa.flash_attention(*n24), flash_attention_plain(*n24),
                       attention_scale(*n24))
    assert res["ok"] and fa.flash_attention(*n24).shape == (2, 333, 4, 24), res
    with pytest.raises(ValueError, match="up to 256"):
        fa.flash_attention(*(torch.cat([t] * 5, -1) for t in (q, k, v)))
    with pytest.raises(ValueError, match="unit stride"):
        fa.flash_attention(torch.cat([q, q], -1)[..., ::2], k, v)  # a stride of 2 on dh
    before = fa.LAUNCHES
    assert fa.flash_attention(q[:, :0], k[:, :0], v[:, :0]).shape == (2, 0, 4, 64)
    assert fa.LAUNCHES == before


@pytest.mark.cuda
def test_lm_serving_on_the_card_equals_the_cpu(cuda):
    """The smoke gemma3 prefill (bf16) on the card, one K6 launch a layer,
    against the CPU run of the same params; a decode step and a short
    DecodeEngine run as well."""
    import dataclasses

    from repro_torch.configs import build_step, get_arch, init_params, make_batch, resolve_config
    from repro_torch.serve import DecodeEngine, ServeConfig

    arch = get_arch("gemma3-1b")
    cell = arch.cell("prefill_32k")
    cfg = dataclasses.replace(resolve_config(arch, cell, smoke=True), dtype="bfloat16")
    params = init_params(arch, cfg, seed=0, device=cuda)
    cpu_params = {"embed": params["embed"].cpu(), "final_norm": params["final_norm"].cpu(),
                  "layers": [{n: t.cpu() for n, t in p.items()} for p in params["layers"]]}
    step, _ = build_step(arch, cell, cfg)
    before = fa.LAUNCHES
    got = step(params, make_batch(arch, cell, cfg, seed=1, device=cuda))
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + cfg.n_layers
    want = step(cpu_params, make_batch(arch, cell, cfg, seed=1, device="cpu"))
    torch.testing.assert_close(got.float().cpu(), want.float(), rtol=0.05, atol=0.05)
    dcell = arch.cell("decode_32k")
    dstep, _ = build_step(arch, dcell, cfg)
    logits, _ = dstep(params, make_batch(arch, dcell, cfg, seed=2, device=cuda))
    want, _ = dstep(cpu_params, make_batch(arch, dcell, cfg, seed=2, device="cpu"))
    torch.testing.assert_close(logits.float().cpu(), want.float(), rtol=0.05, atol=0.05)
    eng = DecodeEngine(params, cfg, ServeConfig(max_batch=2, max_len=32, eos_token=-1),
                       device=cuda)
    for p in ([1, 2, 3], [4, 5], [6, 7, 8, 9]):
        eng.submit(p, max_new=4)
    done = eng.run_until_drained()
    assert sorted(done) == [0, 1, 2] and all(len(t) == 4 for t in done.values())


@pytest.mark.cuda
def test_live_updates_on_the_card_equal_the_cpu(cuda):
    """Live updates on the card: each epoch's summary, and every probe ×
    join's lists, equal the CPU engine's, compactions and slot updates
    included; the delta buffers' scan is one K1 launch a probe batch, equal
    to its plain version on its real operands."""
    import itertools

    from repro_torch.core import GnnPeConfig, GnnPeEngine, GraphUpdate
    from repro_torch.core import delta as delta_mod
    from repro_torch.graphs import newman_watts_strogatz, random_connected_query

    g = newman_watts_strogatz(400, k=4, p=0.15, n_labels=4, seed=3)
    cfg = GnnPeConfig(n_partitions=3, encoder="monotone", probe_impl="stacked",
                      delta_compact_min=500, delta_compact_frac=0.02, cache=True)
    qs = [random_connected_query(g, 6, seed=s) for s in range(4)]
    cpu = GnnPeEngine(cfg, device="cpu").build(g)
    eng = GnnPeEngine(cfg, device=cuda).build(g)
    rng = np.random.default_rng(0)
    compacted = 0
    for _ in range(4):
        e = cpu.graph.edge_array()
        upd = GraphUpdate(remove_edges=e[rng.choice(e.shape[0], 4, replace=False)],
                          add_edges=rng.integers(0, cpu.graph.n_vertices, (4, 2)))
        s = eng.apply_updates(upd)
        assert s == cpu.apply_updates(upd)
        compacted += len(s["compacted"])
        seen = []
        saved = delta_mod._pairs_keep_mask
        delta_mod._pairs_keep_mask = lambda *a: seen.append(a) or saved(*a)
        before = ops.LAUNCHES
        try:
            got = eng._match_many_core(qs, "path", "loop", "numpy")[0]
        finally:
            delta_mod._pairs_keep_mask = saved
        assert len(seen) == int(eng.delta.any_rows())
        assert ops.LAUNCHES == before + 1 + len(seen)
        for a in seen:
            assert torch.equal(ops.dominance_scan_pairs_indexed(*a),
                               dominance_scan_pairs_indexed_ref(*a))
        assert got == cpu._match_many_core(qs, "path", "loop", "numpy")[0]
        for probe, join in itertools.product(("loop", "stacked"), ("numpy", "device")):
            kw = dict(probe_impl=probe, join_impl=join)
            assert eng.match_many(qs, **kw) == cpu.match_many(qs, **kw), kw
    assert compacted and eng.stacked_probe() is not None


@pytest.mark.cuda
def test_probe_device_live_mask_on_the_card_equals_the_host_filter(cuda):
    """``probe_device``'s tombstone mask on the card: each probe's
    candidates equal the unmasked probe's rows less the dead ones, filtered
    on the host, in slot order; some rows were dead."""
    from repro_torch.core import GnnPeConfig, GnnPeEngine, GraphUpdate
    from repro_torch.graphs import newman_watts_strogatz, random_connected_query

    g = newman_watts_strogatz(400, k=4, p=0.15, n_labels=4, seed=3)
    eng = GnnPeEngine(GnnPeConfig(n_partitions=3, encoder="monotone", probe_impl="stacked",
                                  delta_compact_min=10**9), device=cuda).build(g)
    eng.apply_updates(GraphUpdate(remove_edges=g.edge_array()[::40]))
    probe = eng.stacked_probe()
    live = eng._stacked_live_mask(probe)
    assert live is not None and not bool(live.all())
    qs = [random_connected_query(g, 6, seed=s) for s in range(6)]
    q_embs = eng._query_node_embeddings_many(qs)
    reqs = [(qi, p) for qi, q in enumerate(qs) for p in eng._deg_plan_cached(q).paths]
    dev_memo, dev_counts = {}, {}
    eng._probe_batch(reqs, q_embs, {}, qs, "stacked", dev_memo=dev_memo, dev_counts=dev_counts)
    unmasked = {}
    eng._live_mask_cache[None] = (eng.epoch, probe.stacked, None)  # the probe without the mask
    eng._probe_batch(reqs, q_embs, unmasked, qs, "stacked")
    live_h, dropped = live.cpu(), 0
    for qi, p in dev_memo:
        parts = []
        for mi in np.argsort(probe.stacked.slot_of):
            rows = unmasked[(mi, qi, p)].cpu()
            kept = rows[live_h[int(probe.stacked.slot_of[mi]), rows]]
            dropped += rows.numel() - kept.numel()
            assert dev_counts[(mi, qi, p)] == kept.numel()
            parts.append(eng.models[mi].index.paths[kept.to(cuda)])
        assert torch.equal(dev_memo[(qi, p)], torch.cat(parts).to(torch.int32))
    assert dropped > 0


# ----------------------------------------------------- training backwards ---


@pytest.mark.cuda
def test_kernel_functions_carry_gradients_on_the_card(cuda):
    """K4, K5 and K6 launch inside their ``autograd.Function``s and hand back
    gradients equal to autograd through their plain versions on the card."""
    idx, mask, table = (torch.from_numpy(a).to(cuda) for a in make_bags(300, 2, 50, 16, seed=1))
    t1, t2 = (table.clone().requires_grad_(True) for _ in range(2))
    g = torch.randn(300, 16, device=cuda, generator=torch.Generator(cuda).manual_seed(2))
    before = sa.LAUNCHES
    (sa.star_agg(idx, mask, t1) * g).sum().backward()
    assert sa.LAUNCHES == before + 1
    (star_agg_ref(idx, mask, t2) * g).sum().backward()
    torch.testing.assert_close(t1.grad, t2.grad, rtol=1e-6, atol=1e-6)

    ops5 = [torch.from_numpy(a).to(cuda) for a in make_cross(512, 429, seed=3)]
    a5, b5 = ([t.clone().requires_grad_(True) for t in ops5] for _ in range(2))
    up = torch.randn(512, 429, device=cuda, generator=torch.Generator(cuda).manual_seed(4))
    before = ci.LAUNCHES
    (ci.cross_interact(*a5) * up).sum().backward()
    assert ci.LAUNCHES == before + 1
    (cross_interact_ref(*b5) * up).sum().backward()
    for x, y in zip(a5, b5):  # the forward differs by K5's 3xTF32 rounding only
        assert float((x.grad - y.grad).norm() / y.grad.norm()) < 1e-4

    q, k, v = (torch.from_numpy(a).to(cuda).to(torch.bfloat16)
               for a in make_attn(1, 384, 4, 1, 64, seed=5))
    a6, b6 = ([t.clone().requires_grad_(True) for t in (q, k, v)] for _ in range(2))
    o = fa.flash_attention(*a6, window=100, chunk=128)
    up = torch.randn(o.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(6))
    got = torch.autograd.grad(o, a6, up.to(o.dtype))
    want = torch.autograd.grad(flash_attention_plain(*b6, True, 100, 128), b6, up.to(o.dtype))
    for x, y in zip(got, want):
        assert float((x.float() - y.float()).norm() / y.float().norm()) < 1e-3


@pytest.mark.cuda
def test_kernels_launch_alike_directly_and_through_their_custom_ops(cuda):
    """A plain card tensor with no dispatch mode active launches K4, K5 and K6
    directly; under a dispatch mode (a flop counter) each goes through its
    custom op, which counts its formula.  Both launch once and agree bit for bit."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.device import dispatcher_watches

    idx, mask, table = (torch.from_numpy(a).to(cuda) for a in make_bags(64, 3, 50, 16, seed=1))
    x0, x, w, b = (torch.from_numpy(a).to(cuda) for a in make_cross(32, 24, seed=2))
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k = (torch.randn(1, 128, h, 64, generator=g, device=cuda, dtype=torch.bfloat16)
            for h in (4, 2))
    calls = [(sa, lambda: sa.star_agg(idx, mask, table)),
             (ci, lambda: ci.cross_interact(x0, x, w, b)),
             (fa, lambda: fa.flash_attention(q, k, k))]
    assert not dispatcher_watches(table)
    for mod, call in calls:
        before = mod.LAUNCHES
        direct = call()
        with FlopCounterMode(display=False) as fc:
            assert dispatcher_watches(table)
            seen = call()
        torch.cuda.synchronize()
        assert mod.LAUNCHES == before + 2
        assert fc.get_total_flops() > 0
        assert torch.equal(direct, seen)
