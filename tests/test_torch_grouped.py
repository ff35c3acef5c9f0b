"""GNN-PGE's grouped index on the CPU, held against the JAX package.

From the same indexes the port's group sidecar equals the reference's
field by field (sizes 1 to 32 and an empty index) and ``choose_group_size``
picks the same size; K1's groups form (its plain version: one pairs call on
concatenated operands) equals the reference's ``dominance_scan_groups_ref``
bit for bit, ties at every eps edge included; the grouped loop and stacked
probes return the reference's rows and stats dicts, also over mixed group
sizes and all-empty partitions; and grouped engines (fixed and auto sizes)
give the reference engine's match lists for every probe, join and plan
weight, and VF2's sets."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import GnnPeConfig as RefConfig  # noqa: E402
from repro.core import GnnPeEngine as RefEngine  # noqa: E402
from repro.core import grouping as RG  # noqa: E402
from repro.core import index as RI  # noqa: E402
from repro.core import stacked as RS  # noqa: E402
from repro.dist.probe import StackedProbe as RefProbe  # noqa: E402
from repro.graphs import erdos_renyi, random_connected_query  # noqa: E402
from repro.kernels.dominance_scan import ops as ref_ops  # noqa: E402
from repro.kernels.dominance_scan import ref as ref_k  # noqa: E402
from repro_torch.convert import partition_state_from_reference  # noqa: E402
from repro_torch.core import GnnPeConfig, GnnPeEngine, vf2_match  # noqa: E402
from repro_torch.core import grouping as PG  # noqa: E402
from repro_torch.core import index as PI  # noqa: E402
from repro_torch.core import stacked as PS  # noqa: E402
from repro_torch.dist import StackedProbe  # noqa: E402
from repro_torch.graphs import Graph  # noqa: E402
from repro_torch.kernels.dominance_scan import ops  # noqa: E402
from repro_torch.kernels.dominance_scan.ref import dominance_scan_groups_ref, make_groups  # noqa: E402

SIZES = [700, 20, 1, 0, 300]  # the last partition's labels match no query


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def indexes(seed: int, quantize: bool, n_gnn: int, sizes=SIZES, group_sizes=None):
    """The same partitions as reference and port indexes (block size 32),
    with group sidecars at ``group_sizes`` (one a partition, cycled)."""
    rng = np.random.default_rng(seed)
    vocab = rng.random((3, 2)).astype(np.float32)
    alien = (vocab + 7.0).astype(np.float32)
    L, D = 3, 6
    ref, port = [], []
    for i, P in enumerate(sizes):
        voc = alien if i == len(sizes) - 1 else vocab
        emb = rng.random((P, D)).astype(np.float32)
        lab = rng.integers(0, 3, (P, L)).astype(np.int32)
        emb_multi = rng.random((n_gnn, P, D)).astype(np.float32)
        paths = rng.integers(0, 100, (P, L)).astype(np.int32)
        r = RI.build_index(paths, emb, voc[lab].reshape(P, D), emb_multi, block_size=32,
                           quantize=quantize, path_labels=lab if quantize else None)
        p = PI.build_index(_t(paths.astype(np.int64)), _t(emb), _t(voc[lab].reshape(P, D)),
                           _t(emb_multi), block_size=32, quantize=quantize,
                           path_labels=_t(lab.astype(np.int64)) if quantize else None)
        if group_sizes is not None:
            gsz = group_sizes[i % len(group_sizes)]
            RG.attach_groups(r, gsz)
            PG.attach_groups(p, gsz)
        ref.append(r)
        port.append(p)
    return ref, port, vocab, rng


def queries(ref: list, vocab, rng, Q: int, n_gnn: int):
    """Per-partition query embeddings as the engine feeds the stacked probe
    ((m, Q, D), (n_gnn, m, Q, D)) and shared label hashes; every other
    query shrunk from a row of the largest partition so that it hits."""
    m, L, D = len(ref), 3, 6
    lab = rng.integers(0, vocab.shape[0], (Q, L)).astype(np.int32)
    q_emb0 = np.ascontiguousarray(np.broadcast_to(vocab[lab].reshape(Q, D), (m, Q, D)))
    q_emb = rng.random((m, Q, D)).astype(np.float32) * 0.7
    q_multi = rng.random((n_gnn, m, Q, D)).astype(np.float32) * 0.7
    qh = RI.hash_labels(lab)
    big = ref[0]
    for qi in range(0, Q, 2):
        r = int(rng.integers(0, big.n_paths))
        q_emb0[:, qi] = big.emb0[r]
        q_emb[0, qi] = big.emb[r] * np.float32(0.9)
        q_multi[:, 0, qi] = big.emb_multi[:, r] * np.float32(0.9)
        if big.label_hash is not None:
            qh[qi] = big.label_hash[r]
    return q_emb.astype(np.float32), q_emb0.astype(np.float32), q_multi, qh


@pytest.mark.parametrize("group_size", [1, 4, 8, 16, 32, "empty"])
def test_sidecar_field_equal_reference(group_size):
    sizes = [0] if group_size == "empty" else [1000]
    gsz = 8 if group_size == "empty" else group_size
    ref, port, _, _ = indexes(gsz, False, 2, sizes=sizes)
    want, got = RG.group_paths(ref[0], gsz), PG.group_paths(port[0], gsz)
    for name in ("group_start", "mbr_hi", "mbr0", "block_group_start"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == (torch.float32 if name.startswith("mbr") else torch.int64)
        np.testing.assert_array_equal(a.numpy(), b)
    assert (got.group_size, got.n_groups) == (want.group_size, want.n_groups)
    assert got.nbytes() == want.nbytes()
    np.testing.assert_array_equal(got.member_counts().numpy(), want.member_counts())
    ref[0].groups, port[0].groups = want, got
    assert port[0].nbytes() == ref[0].nbytes()
    if group_size == "empty":
        assert got.n_groups == 0
    else:
        assert got.n_groups == 1000 // 32 * -(-32 // gsz) + -(-(1000 % 32) // gsz)
    with pytest.raises(ValueError, match="group_size"):
        PG.group_paths(port[0], 0)


@pytest.mark.parametrize("n_vocab,pick", [(1, 32), (2, 16), (3, 8)])
def test_choose_group_size_equals_reference(n_vocab, pick):
    """The same pick from the same index, over label vocabularies where 32,
    16 and 8 win."""
    rng = np.random.default_rng(0)
    P, D = 2000, 6
    vocab = rng.random((n_vocab, 2)).astype(np.float32)
    emb = rng.random((P, D)).astype(np.float32)
    emb0 = vocab[rng.integers(0, vocab.shape[0], (P, 3))].reshape(P, D)
    paths = np.zeros((P, 3), np.int32)
    ref = RI.build_index(paths, emb, emb0, block_size=128)
    port = PI.build_index(_t(paths.astype(np.int64)), _t(emb), _t(emb0), block_size=128)
    assert PG.choose_group_size(port) == RG.choose_group_size(ref) == pick
    size, sidecar = PG._best_grouping(port)
    assert size == sidecar.group_size == RG.choose_group_size(ref)


@pytest.mark.parametrize("T", [1, 1000, 4099])
def test_groups_form_bit_equal_reference(T):
    """Queries exactly at hi + eps, hi0 + eps and lo0 − eps and one ulp
    either side: the plain version, the CPU wrapper (one pairs call on the
    concatenated operands) and the reference's plain, pairs-concatenation
    and interpret-mode kernel forms all agree bit for bit."""
    arrs = make_groups(T, seed=T)
    qg, q0g, hi, lo0, hi0 = (_t(a) for a in arrs)
    launches = ops.LAUNCHES
    got = ops.dominance_scan_groups(qg, q0g, hi, lo0, hi0)
    assert ops.LAUNCHES == launches  # the CPU tensors take the plain version
    plain = dominance_scan_groups_ref(qg, q0g, hi, lo0, hi0)
    want = np.asarray(ref_k.dominance_scan_groups_ref(*arrs)).astype(bool)
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), want)
    for kw in (dict(use_pallas=False), dict(use_pallas=True, interpret=True)):
        np.testing.assert_array_equal(
            np.asarray(ref_ops.dominance_scan_groups(*arrs, **kw)).astype(bool), want
        )
    if T >= 1000:  # the edges are there, and they decide both ways
        eps = np.float32(1e-6)
        q0, l0, h0 = arrs[1], arrs[3], arrs[4]
        assert (q0 == (l0 - eps)).sum() > 0 and (q0 == (h0 + eps)).sum() > 0
        assert (arrs[0] == (arrs[2] + eps)).sum() > 0
        assert 0 < want.sum() < T


def _record(name: str, seen: list):
    """Wrap ``PI.<name>`` so every fused verdict's operands and result land in ``seen``."""
    fn = getattr(PI, name)

    def record(*a):
        out = fn(*a)
        seen.append((name, a, out))
        return out

    return fn, record


@pytest.mark.parametrize("n_gnn", [0, 2])
@pytest.mark.parametrize("quantize", [False, True])
def test_grouped_loop_probe_equals_reference(n_gnn, quantize):
    """Rows, stats dicts and pair counters of the port's two-level loop
    probe equal the reference's over mixed group sizes; its rows equal the
    path kind's from fewer leaf pairs, through ONE group verdict and ONE
    member verdict."""
    ref, port, vocab, rng = indexes(10 + n_gnn + quantize, quantize, n_gnn,
                                    group_sizes=(8, 16, 32, 4))
    Q = 7
    q_emb, q_emb0, q_multi, qh = queries(ref, vocab, rng, Q, n_gnn)
    ref_items = [(ix, q_emb[i], q_emb0[i], q_multi[:, i] if n_gnn else None,
                  qh if quantize else None) for i, ix in enumerate(ref)]
    items = [(ix, _t(q_emb[i]), _t(q_emb0[i]), _t(q_multi[:, i]) if n_gnn else None,
              _t(qh) if quantize else None) for i, ix in enumerate(port)]
    RI.reset_pair_counters()
    want, want_stats = RI.query_index_batch_multi(ref_items, return_stats=True,
                                                  use_pallas=False, use_groups=True)
    want_pairs = dict(RI.PAIR_COUNTERS)
    seen: list = []
    saved = [_record(n, seen) for n in ("_groups_keep_mask", "_pairs_keep_mask")]
    PI._groups_keep_mask, PI._pairs_keep_mask = saved[0][1], saved[1][1]
    try:
        PI.reset_pair_counters()
        got, got_stats = PI.query_index_batch_multi(items, return_stats=True, use_groups=True)
        got_pairs = {k: PI.PAIR_METRIC.get(kind=k) for k in want_pairs}
    finally:
        PI._groups_keep_mask, PI._pairs_keep_mask = saved[0][0], saved[1][0]
    assert [s[0] for s in seen] == ["_groups_keep_mask", "_pairs_keep_mask"]
    assert got_stats == want_stats
    assert got_pairs == want_pairs and want_pairs["group_pairs"] > 0
    PI.reset_pair_counters()
    flat = PI.query_index_batch_multi(items)
    n_hits = 0
    for i in range(len(SIZES)):
        for qi in range(Q):
            np.testing.assert_array_equal(got[i][qi].numpy(), want[i][qi])
            assert torch.equal(got[i][qi], flat[i][qi])
            n_hits += int(want[i][qi].size > 0)
    assert n_hits > 0
    assert got_pairs["leaf_pairs"] < PI.PAIR_METRIC.get(kind="leaf_pairs")


@pytest.mark.parametrize("cap", [7, 1 << 21])
@pytest.mark.parametrize("device_stage", ["numpy", "batched"])
@pytest.mark.parametrize("quantize,n_gnn", [(False, 0), (True, 2)])
def test_grouped_stacked_probe_equals_reference(quantize, n_gnn, device_stage, cap):
    """The stacked probe's grouped rows, stats, counters and per-partition
    leaf pairs equal the reference's stacked probe and the port's loop
    probe, with heterogeneous group sizes (empty slots of the coarser
    partitions never pass)."""
    ref, port, vocab, rng = indexes(20 + n_gnn, quantize, n_gnn, group_sizes=(32, 8, 16))
    Q = 6
    q_emb, q_emb0, q_multi, qh = queries(ref, vocab, rng, Q, n_gnn)
    args = (_t(q_emb), _t(q_emb0), _t(q_multi) if n_gnn else None)
    RI.reset_pair_counters()
    ref_probe = RefProbe(ref, leaf_pair_cap=cap)
    want, want_stats = ref_probe.probe(
        q_emb, q_emb0, q_multi if n_gnn else None, q_label_hash=qh if quantize else None,
        use_groups=True, use_pallas=False, return_stats=True, device_stage="numpy",
    )
    want_pairs = dict(RI.PAIR_COUNTERS)
    PI.reset_pair_counters()
    probe = StackedProbe(port, leaf_pair_cap=cap)
    assert probe.stacked.groups.gpb == 4 and probe.stacked.groups.group_size == 8
    assert probe.stacked.nbytes() == ref_probe.stacked.nbytes()
    got, got_stats = probe.probe(*args, q_label_hash=_t(qh) if quantize else None,
                                 use_groups=True, return_stats=True, device_stage=device_stage)
    assert {k: PI.PAIR_METRIC.get(kind=k) for k in want_pairs} == want_pairs
    assert got_stats == want_stats
    np.testing.assert_array_equal(probe.part_leaf_pairs, ref_probe.part_leaf_pairs)
    loop = PI.query_index_batch_multi(
        [(ix, args[0][i], args[1][i], args[2][:, i] if n_gnn else None,
          _t(qh) if quantize else None) for i, ix in enumerate(port)],
        use_groups=True,
    )
    for i in range(len(SIZES)):
        for qi in range(Q):
            np.testing.assert_array_equal(got[i][qi].numpy(), want[i][qi])
            assert torch.equal(got[i][qi], loop[i][qi])
    assert sum(r.numel() for part in got for r in part) > 0


def test_stacked_groups_fields_equal_reference():
    ref, port, _, _ = indexes(3, True, 1, group_sizes=(16, 32, 8))
    want = RS.build_stacked(ref).groups
    got = PS.build_stacked(port).groups
    for name in ("hi", "lo0", "hi0", "start", "count"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name))
    assert (got.gpb, got.group_size, got.nbytes()) == (want.gpb, want.group_size, want.nbytes())


@pytest.fixture(scope="module")
def graph():
    return erdos_renyi(200, avg_degree=3.5, n_labels=4, seed=5)


@pytest.mark.parametrize("mode", ["fixed", "auto"])
@pytest.mark.parametrize("plan_weight", ["deg", "dr"])
def test_grouped_engine_equals_reference(graph, mode, plan_weight):
    """Every index kind × probe × join of a grouped engine (5 partitions,
    so slot order differs from engine order) gives the reference engine's
    match lists and VF2's sets; its build stats equal the reference's."""
    cfg = dict(
        n_partitions=5, encoder="monotone", n_multi=1, block_size=32, index_kind="grouped",
        group_size=8, group_size_mode=mode, plan_weight=plan_weight,
        quantize_index=plan_weight == "dr",
    )
    ref = RefEngine(RefConfig(**cfg)).build(graph)
    g = Graph(graph.offsets, graph.nbrs, graph.labels)
    eng = GnnPeEngine(GnnPeConfig(**cfg), device="cpu").build(
        g, params=partition_state_from_reference(ref.models)
    )
    for key in ("n_groups", "group_sizes", "group_bytes", "index_bytes"):
        assert eng.offline_stats[key] == ref.offline_stats[key]
    assert eng.offline_stats["n_groups"] > 0
    assert list(eng.stacked_probe().stacked.slot_of) != list(range(5))
    qs = [random_connected_query(graph, 4 + s % 3, seed=50 + s) for s in range(4)]
    oracle = [set(vf2_match(g, q)) for q in qs]
    for kind, probe, join in itertools.product(("path", "grouped"), ("loop", "stacked"),
                                               ("numpy", "device")):
        kw = dict(index_kind=kind, probe_impl=probe, join_impl=join)
        got = eng.match_many(qs, **kw)
        assert got == ref.match_many(qs, **kw), kw
        assert [set(m) for m in got] == oracle
    assert sum(map(len, got)) > 0
    assert eng.match(qs[0], impl="scalar") == ref.match(qs[0], impl="scalar")
