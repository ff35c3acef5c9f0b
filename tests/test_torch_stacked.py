"""The stacked index and the stacked probe on the CPU: from the same
indexes the port's ``build_stacked`` equals the JAX package's field by
field, its descent equals ``stacked_masks_ref``, and ``StackedProbe.probe``
returns the rows of the port's loop probe and of the reference's stacked
probe, on ragged partitions (one path, no path, labels no query has), with
and without the sidecar, for any ``leaf_pair_cap``.  At engine level the
stacked probe's match lists equal the loop probe's, the reference's and
VF2's, with both joins."""
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
from repro_torch.convert import partition_state_from_reference  # noqa: E402
from repro_torch.core import GnnPeConfig, GnnPeEngine, vf2_match  # noqa: E402
from repro_torch.core import grouping as PG  # noqa: E402
from repro_torch.core import index as PI  # noqa: E402
from repro_torch.core import stacked as PS  # noqa: E402
from repro_torch.dist import StackedProbe  # noqa: E402
from repro_torch.dist import probe as probe_mod  # noqa: E402
from repro_torch.graphs import Graph  # noqa: E402
from repro_torch.kernels.dominance_scan.ref import gather_pair_operands  # noqa: E402

SIZES = [900, 20, 1, 0, 300]  # the last partition's labels match no query


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def ragged_indexes(seed: int, quantize: bool, n_gnn: int = 2, sizes=SIZES):
    """The same ragged partitions as reference and port indexes: a
    multi-level one, a one-block one, a one-path one, an empty one and one
    whose label embeddings no query has.  One build geometry for all."""
    rng = np.random.default_rng(seed)
    vocab = rng.random((5, 2)).astype(np.float32)
    alien = (vocab + 7.0).astype(np.float32)
    L, D = 3, 6
    ref, port = [], []
    for i, P in enumerate(sizes):
        voc = alien if i == len(sizes) - 1 else vocab
        emb = rng.random((P, D)).astype(np.float32)
        lab = rng.integers(0, 5, (P, L)).astype(np.int32)
        emb0 = voc[lab].reshape(P, D)
        emb_multi = rng.random((n_gnn, P, D)).astype(np.float32)
        paths = rng.integers(0, 100, (P, L)).astype(np.int32)
        ref.append(RI.build_index(
            paths, emb, emb0, emb_multi, block_size=32,
            quantize=quantize, path_labels=lab if quantize else None,
        ))
        port.append(PI.build_index(
            _t(paths.astype(np.int64)), _t(emb), _t(emb0), _t(emb_multi), block_size=32,
            quantize=quantize, path_labels=_t(lab.astype(np.int64)) if quantize else None,
        ))
    return ref, port, vocab, rng


def queries(ref: list, vocab, rng, Q: int, n_gnn: int):
    """Per-partition query embeddings shaped as the engine feeds the probe
    ((m, Q, D), (n_gnn, m, Q, D)) and shared label hashes: random queries,
    and every other one shrunk from a row of the largest partition."""
    m, L, D = len(ref), 3, 6
    lab = rng.integers(0, vocab.shape[0], (Q, L)).astype(np.int32)
    q_emb0 = np.ascontiguousarray(
        np.broadcast_to(vocab[lab].reshape(Q, D), (m, Q, D))
    ).astype(np.float32)
    q_emb = rng.random((m, Q, D)).astype(np.float32) * 0.8
    q_multi = rng.random((n_gnn, m, Q, D)).astype(np.float32) * 0.8
    qh = RI.hash_labels(lab)
    big = ref[0]
    for qi in range(0, Q, 2) if big.n_paths else ():
        r = int(rng.integers(0, big.n_paths))
        q_emb0[:, qi] = big.emb0[r]
        q_emb[0, qi] = big.emb[r] * np.float32(0.9)
        q_multi[:, 0, qi] = big.emb_multi[:, r] * np.float32(0.9)
        if big.label_hash is not None:
            qh[qi] = big.label_hash[r]
    return q_emb, q_emb0, q_multi, qh


@pytest.mark.parametrize("n_gnn", [0, 1, 2])
@pytest.mark.parametrize("quantize", [False, True])
def test_build_stacked_fields_equal_reference(n_gnn, quantize):
    ref, port, _, _ = ragged_indexes(n_gnn, quantize, n_gnn)
    want = RS.build_stacked(ref, n_shards=1)
    got = PS.build_stacked(port)
    np.testing.assert_array_equal(got.slot_of, want.slot_of)
    assert list(got.slot_of) != list(range(len(SIZES)))  # largest first, not partition order
    np.testing.assert_array_equal(got.n_paths.numpy(), want.n_paths)
    assert (got.n_slots, got.n_levels, got.level_hi[-1].shape[1]) == (
        want.n_slots, want.n_levels, want.n_leaf_blocks,
    )
    for name in ("level_hi", "level_lo0", "level_hi0"):
        for a, b in zip(getattr(got, name), getattr(want, name)):
            np.testing.assert_array_equal(a.numpy(), b)
    for name in ("emb_cat", "emb0", "emb_q", "label_hash"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None) == (name in ("emb_q", "label_hash") and not quantize)
        if a is not None:
            want_dtype = {"emb_q": torch.int8, "label_hash": torch.int64}.get(name, torch.float32)
            assert a.dtype == want_dtype
            np.testing.assert_array_equal(a.numpy(), b)
    assert got.padding_stats() == want.padding_stats()
    assert got.nbytes() == want.nbytes() == got.padding_stats()["stacked_bytes"]


def test_plan_shards_equal_reference():
    sizes = np.asarray([100, 1, 90, 10, 80, 20, 70, 30, 70, 0])
    for n in (1, 3, 4):
        assert PS.plan_shards(sizes, n) == RS.plan_shards(sizes, n)


@pytest.mark.parametrize("n_gnn", [0, 2])
def test_descent_equals_reference_masks(n_gnn, monkeypatch):
    """The batched descent, in one query chunk and in chunks of one query,
    equals the plain ``stacked_masks_ref`` and the reference's."""
    ref, port, vocab, rng = ragged_indexes(7, False, n_gnn)
    st_ref, st = RS.build_stacked(ref), PS.build_stacked(port)
    Q = 9
    q_emb, q_emb0, q_multi, _ = queries(ref, vocab, rng, Q, n_gnn)
    cat = np.concatenate([q_emb, *q_multi], axis=2) if n_gnn else q_emb
    q_cat = np.zeros((st.n_slots, Q, cat.shape[2]), np.float32)
    q0 = np.zeros((st.n_slots, Q, 6), np.float32)
    q_cat[st_ref.slot_of], q0[st_ref.slot_of] = cat, q_emb0
    want, _ = RS.stacked_masks_ref(st_ref, q_cat, q0)
    plain, _ = PS.stacked_masks_ref(st, _t(q_cat), _t(q0))
    np.testing.assert_array_equal(plain.numpy(), want)
    assert want.any() and not want.all()
    probe = StackedProbe(port)
    for budget in (1 << 28, 1):  # one chunk; one query a chunk
        monkeypatch.setattr(probe_mod, "_MASK_BUDGET", budget)
        got, gkeep = probe._device_masks(_t(q_cat), _t(q0), 1e-6, "batched")
        np.testing.assert_array_equal(got.numpy(), want)
        assert gkeep is None
    with pytest.raises(ValueError, match="PackedGroupIndex sidecar"):
        PS.stacked_masks_ref(st, _t(q_cat), _t(q0), use_groups=True)
    # with group sidecars of mixed sizes, the group masks equal the reference's too
    for i, (r, p) in enumerate(zip(ref, port)):
        RG.attach_groups(r, (8, 16, 32)[i % 3])
        PG.attach_groups(p, (8, 16, 32)[i % 3])
    st_ref = RS.build_stacked(ref)
    want, want_g = RS.stacked_masks_ref(st_ref, q_cat, q0, use_groups=True)
    plain, plain_g = PS.stacked_masks_ref(PS.build_stacked(port), _t(q_cat), _t(q0), use_groups=True)
    np.testing.assert_array_equal(plain_g.numpy(), want_g)
    assert want_g.any() and not want_g.all()
    probe = StackedProbe(port)
    for budget in (1 << 28, 1):
        monkeypatch.setattr(probe_mod, "_MASK_BUDGET", budget)
        got, gkeep = probe._device_masks(_t(q_cat), _t(q0), 1e-6, "batched", use_groups=True)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(gkeep.numpy(), want_g)


@pytest.mark.parametrize("cap", [7, 1 << 21])
@pytest.mark.parametrize("device_stage", ["numpy", "batched"])
@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("n_gnn", [0, 1, 2])
def test_stacked_probe_equals_loop_and_reference(n_gnn, quantize, device_stage, cap):
    """Rows per (partition, query), leaf pairs per partition and the pair
    counter of the port's stacked probe equal its loop probe's and the
    reference's stacked probe's; the verdict sees the same pairs as the
    loop probe's."""
    ref, port, vocab, rng = ragged_indexes(n_gnn + 3 * quantize, quantize, n_gnn)
    Q = int(rng.integers(2, 12))
    q_emb, q_emb0, q_multi, qh = queries(ref, vocab, rng, Q, n_gnn)
    items = [
        (ix, _t(q_emb[i]), _t(q_emb0[i]), _t(q_multi[:, i]) if n_gnn else None,
         _t(qh) if quantize else None)
        for i, ix in enumerate(port)
    ]
    seen = []
    keep_mask = PI._pairs_keep_mask

    def record(*a):
        out = keep_mask(*a)
        segs = a[0]
        for seg, keep in zip(segs, torch.split(out, [s.rows.numel() for s in segs])):
            qg, q0g, eg, e0g = gather_pair_operands(seg)
            seen.append((torch.cat([qg, q0g], 1), torch.cat([eg, e0g], 1), keep))
        return out

    PI._pairs_keep_mask = record
    try:
        PI.reset_pair_counters()
        loop = PI.query_index_batch_multi(items)
        loop_pairs, loop_seen = PI.PAIR_METRIC.get(kind="leaf_pairs"), seen[:]
        seen.clear()
        PI.reset_pair_counters()
        probe = StackedProbe(port, leaf_pair_cap=cap)
        got = probe.probe(
            _t(q_emb), _t(q_emb0), _t(q_multi) if n_gnn else None,
            q_label_hash=_t(qh) if quantize else None, device_stage=device_stage,
        )
        assert PI.PAIR_METRIC.get(kind="leaf_pairs") == loop_pairs > 0
    finally:
        PI._pairs_keep_mask = keep_mask
    ref_probe = RefProbe(ref, leaf_pair_cap=cap)
    want = ref_probe.probe(
        q_emb, q_emb0, q_multi if n_gnn else None, q_label_hash=qh if quantize else None,
        use_pallas=False, device_stage="numpy",
    )
    # the loop probe's leaf pairs, one partition at a time
    loop_part_pairs = []
    for item in items:
        PI.reset_pair_counters()
        PI.query_index_batch_multi([item])
        loop_part_pairs.append(PI.PAIR_METRIC.get(kind="leaf_pairs"))
    n_hits = 0
    for i in range(len(SIZES)):
        for qi in range(Q):
            assert got[i][qi].dtype == torch.int64
            np.testing.assert_array_equal(got[i][qi].numpy(), want[i][qi])
            np.testing.assert_array_equal(got[i][qi].numpy(), loop[i][qi].numpy())
            n_hits += int(want[i][qi].size > 0)
    assert n_hits > 0
    np.testing.assert_array_equal(probe.part_leaf_pairs, ref_probe.part_leaf_pairs)
    np.testing.assert_array_equal(probe.part_leaf_pairs, loop_part_pairs)
    assert probe.part_leaf_pairs.sum() == loop_pairs
    assert probe.part_leaf_pairs[SIZES.index(0)] == 0
    # the verdict's pairs, as multisets, and their verdicts equal the loop's
    def pairs(s):
        if not s:
            return []
        q, e, k = (torch.cat(t) for t in zip(*s))
        return sorted(zip(map(tuple, q.tolist()), map(tuple, e.tolist()), k.tolist()))

    assert pairs(seen) == pairs(loop_seen)
    if cap == 7:
        assert len(seen) > 1  # the cap chunked the expansion


def test_all_empty_partitions_and_grouped():
    ref, port, vocab, rng = ragged_indexes(5, True, 2, sizes=[0, 0, 0])
    probe = StackedProbe(port)
    q_emb, q_emb0, q_multi, qh = queries(ref, vocab, rng, 4, 2)
    args = (_t(q_emb), _t(q_emb0), _t(q_multi))
    got = probe.probe(*args, q_label_hash=_t(qh))
    want = RefProbe(ref).probe(q_emb, q_emb0, q_multi, q_label_hash=qh, use_pallas=False)
    assert [[r.numel() for r in part] for part in got] == [[r.size for r in part] for part in want]
    assert all(r.numel() == 0 for part in got for r in part)
    assert probe.part_leaf_pairs.tolist() == [0, 0, 0]
    assert probe.probe(*(a[:, :0] for a in args[:2]), None) == [[], [], []]
    # all partitions empty: the grouped probe needs no sidecar and returns
    # the reference's empty rows and zero stats
    got, got_stats = probe.probe(*args, use_groups=True, return_stats=True)
    want, want_stats = RefProbe(ref).probe(
        q_emb, q_emb0, q_multi, use_groups=True, return_stats=True, use_pallas=False
    )
    assert [[r.numel() for r in part] for part in got] == [[r.size for r in part] for part in want]
    assert got_stats == want_stats
    # a stack with paths and no sidecar refuses the grouped probe, as the reference's
    ref, port, vocab, rng = ragged_indexes(5, True, 2)
    q_emb, q_emb0, q_multi, qh = queries(ref, vocab, rng, 4, 2)
    with pytest.raises(ValueError, match="PackedGroupIndex sidecar"):
        StackedProbe(port).probe(_t(q_emb), _t(q_emb0), _t(q_multi), use_groups=True)
    with pytest.raises(ValueError, match="PackedGroupIndex sidecar"):
        RefProbe(ref).probe(q_emb, q_emb0, q_multi, use_groups=True, use_pallas=False)


@pytest.fixture(scope="module")
def graph():
    return erdos_renyi(140, avg_degree=3.5, n_labels=4, seed=5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_stacked_equals_loop_and_oracle(graph, seed):
    """Engine level (the reference's path-kind case and two more): the
    stacked probe's memo and match lists equal the loop probe's, the
    reference engine's and VF2's sets, with both joins; the stacking's
    bytes land in offline_stats as the reference's do."""
    cfg = dict(
        n_partitions=3, encoder="monotone", n_multi=seed, block_size=32,
        quantize_index=bool(seed), probe_impl="stacked",
        plan_weight="dr" if seed == 2 else "deg",
    )
    ref = RefEngine(RefConfig(**cfg)).build(graph)
    g = Graph(graph.offsets, graph.nbrs, graph.labels)
    eng = GnnPeEngine(GnnPeConfig(**cfg), device="cpu").build(
        g, params=partition_state_from_reference(ref.models)
    )
    for key in ("stacked_bytes", "stacked_real_bytes", "stacked_padding_frac"):
        assert eng.offline_stats[key] == ref.offline_stats[key]
    assert eng.offline_stats["stacked_bytes"] > 0
    qs = [random_connected_query(graph, 4 + s % 3, seed=50 + s) for s in range(4)]
    lists = {}
    for jimpl in ("numpy", "device"):
        lists[jimpl] = eng.match_many(qs, join_impl=jimpl)  # the config's stacked probe
        loop = eng.match_many(qs, probe_impl="loop", join_impl=jimpl)
        assert lists[jimpl] == loop == ref.match_many(qs, join_impl=jimpl)
        for q, m in zip(qs, lists[jimpl]):
            assert set(m) == set(vf2_match(g, q))
    assert sum(map(len, lists["numpy"])) > 0
    assert eng.match(qs[0]) == eng.match(qs[0], probe_impl="loop") == lists["numpy"][0]
    # the two probes fill identical memo entries
    q_embs = eng._query_node_embeddings_many(qs)
    reqs = [(qi, p) for qi, q in enumerate(qs) for p in eng._deg_plan_cached(q).paths]
    memos = {}
    for impl in ("loop", "stacked"):
        memos[impl] = {}
        eng._probe_batch(reqs, q_embs, memos[impl], qs, impl)
    assert memos["loop"].keys() == memos["stacked"].keys() and memos["loop"]
    for k, rows in memos["loop"].items():
        assert torch.equal(rows, memos["stacked"][k])
    with pytest.raises(ValueError, match="probe_impl"):
        eng.match_many(qs, probe_impl="bogus")
