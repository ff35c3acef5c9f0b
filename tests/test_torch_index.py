"""Packed index and loop probe: from the same embeddings the port's index
equals the JAX package's ``PackedIndex`` field by field, and the batched
multi-partition probe returns the same rows per (partition, query).

The layout is compared only from shared embeddings: a one-ulp change in
an embedding can move a Morton key and so reorder the index."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.grouping import attach_groups as ref_attach  # noqa: E402
from repro.core.index import build_index as ref_build  # noqa: E402
from repro.core.index import query_index_batch_multi as ref_probe  # noqa: E402
from repro_torch.core.grouping import attach_groups  # noqa: E402
from repro_torch.core.index import (  # noqa: E402
    PAIR_METRIC,
    build_index,
    query_index_batch_multi,
    reset_pair_counters,
)


def make_embeddings(P: int, D: int, n_multi: int, seed: int):
    """Seeded path embeddings with repeated label rows (ties in the label
    sort), values on the Morton grid (k/256) and all-ones rows."""
    rng = np.random.default_rng(seed)
    paths = rng.integers(0, 10_000, (P, 3)).astype(np.int32)
    emb = rng.random((P, D), dtype=np.float32)
    emb[rng.random(P) < 0.1] = 1.0
    grid = rng.random((P, D)) < 0.05
    emb[grid] = rng.integers(0, 256, grid.sum()).astype(np.float32) / np.float32(256)
    labels = rng.random((5, D), dtype=np.float32)
    emb0 = labels[rng.integers(0, 5, P)]
    emb_multi = rng.random((n_multi, P, D), dtype=np.float32)
    return paths, emb, emb0, emb_multi


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def build_both(P, D, n_multi, seed, block_size=16, fanout=4):
    paths, emb, emb0, emb_multi = make_embeddings(P, D, n_multi, seed)
    ref = ref_build(paths, emb, emb0, emb_multi, block_size=block_size, fanout=fanout)
    port = build_index(
        _t(paths.astype(np.int64)), _t(emb), _t(emb0), _t(emb_multi),
        block_size=block_size, fanout=fanout,
    )
    return ref, port


@pytest.mark.parametrize("D", [6, 9])  # 9·8 = 72 key bits: the uint64 key wraps
@pytest.mark.parametrize("seed", [0, 1])
def test_index_equals_reference_field_by_field(D, seed):
    ref, port = build_both(1500 + 37 * seed, D, 2, seed)
    np.testing.assert_array_equal(port.paths.numpy(), ref.paths)
    np.testing.assert_array_equal(port.emb.numpy(), ref.emb)
    np.testing.assert_array_equal(port.emb0.numpy(), ref.emb0)
    np.testing.assert_array_equal(port.emb_multi.numpy(), ref.emb_multi)
    assert len(port.levels) == len(ref.levels) >= 3
    for lv, rlv in zip(port.levels, ref.levels):
        for k in ("mbr", "mbr0", "mbr_multi"):
            np.testing.assert_array_equal(lv[k].numpy(), rlv[k])
    assert (port.block_size, port.fanout) == (ref.block_size, ref.fanout)


def test_index_without_multi_gnns():
    ref, port = build_both(300, 6, 0, 4)
    np.testing.assert_array_equal(port.paths.numpy(), ref.paths)
    for lv, rlv in zip(port.levels, ref.levels):
        np.testing.assert_array_equal(lv["mbr_multi"].numpy(), rlv["mbr_multi"])


def _queries(index, Q: int, seed: int):
    """Queries shrunk from index rows (so they hit) plus random ones."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, index.n_paths, Q)
    scale = rng.uniform(0.6, 1.0, (Q, 1)).astype(np.float32)
    q_emb = (index.emb[rows] * scale).astype(np.float32)
    q_emb0 = index.emb0[rows].copy()
    q_multi = (index.emb_multi[:, rows] * scale[None]).astype(np.float32)
    q_emb[Q // 2 :] = rng.random((Q - Q // 2, index.emb.shape[1]), dtype=np.float32)
    return q_emb, q_emb0, q_multi


def test_batched_probe_rows_equal_reference():
    parts = [build_both(900 + 100 * s, 6, 2, 10 + s) for s in range(3)]
    ref_items, items = [], []
    for s, (ref, port) in enumerate(parts):
        q_emb, q_emb0, q_multi = _queries(ref, 12 + s, seed=s)
        ref_items.append((ref, q_emb, q_emb0, q_multi, None))
        items.append((port, _t(q_emb), _t(q_emb0), _t(q_multi), None))
    want, want_stats = ref_probe(ref_items, use_pallas=False, return_stats=True)
    reset_pair_counters()
    got, got_stats = query_index_batch_multi(items, return_stats=True)
    assert PAIR_METRIC.get(kind="leaf_pairs") > 0
    n_hits = 0
    for w_part, g_part in zip(want, got):
        assert len(w_part) == len(g_part)
        for w, g in zip(w_part, g_part):
            np.testing.assert_array_equal(g.numpy(), w)
            n_hits += int(w.size > 0)
    assert n_hits > 10
    assert got_stats == want_stats
    # the Pallas path of the reference (interpret mode) returns the same rows
    want_pallas = ref_probe(ref_items, use_pallas=True)
    for w_part, g_part in zip(want_pallas, got):
        for w, g in zip(w_part, g_part):
            np.testing.assert_array_equal(g.numpy(), w)


def test_probe_of_empty_index_and_empty_batch():
    ref, port = build_both(200, 6, 2, 3)
    empty = build_index(
        torch.zeros((0, 3), dtype=torch.int64), torch.zeros((0, 6)), torch.zeros((0, 6)),
        torch.zeros((2, 0, 6)),
    )
    q = torch.rand(4, 6)
    out = query_index_batch_multi(
        [(empty, q, q, torch.zeros(2, 4, 6), None), (port, q[:0], q[:0], torch.zeros(2, 0, 6), None)]
    )
    assert [len(o) for o in out] == [4, 0]
    assert all(r.numel() == 0 for r in out[0])
    # the grouped probe needs the sidecar, as the reference's does
    with pytest.raises(ValueError, match="PackedGroupIndex sidecar"):
        query_index_batch_multi([(port, q, q, None, None)], use_groups=True)
    with pytest.raises(ValueError, match="PackedGroupIndex sidecar"):
        ref_probe([(ref, q.numpy(), q.numpy(), None, None)], use_groups=True, use_pallas=False)
    # with it, the grouped probe of the empty index and an empty batch
    # returns what the reference's does, stats included
    ref_attach(ref, 8)
    attach_groups(port, 8)
    attach_groups(empty, 8)
    got, got_stats = query_index_batch_multi(
        [(empty, q, q, None, None), (port, q, q, None, None), (port, q[:0], q[:0], None, None)],
        use_groups=True, return_stats=True,
    )
    want, want_stats = ref_probe(
        [(ref, q.numpy(), q.numpy(), None, None), (ref, q[:0].numpy(), q[:0].numpy(), None, None)],
        use_groups=True, return_stats=True, use_pallas=False,
    )
    assert [len(o) for o in got] == [4, 4, 0]
    assert all(r.numel() == 0 for r in got[0])
    assert got_stats[0] == [dict.fromkeys(want_stats[0][0], 0)] * 4
    assert got_stats[1:] == want_stats
    for g, w in zip(got[1], want[0]):
        np.testing.assert_array_equal(g.numpy(), w)
