"""The int8 + label-hash leaf sidecar on the CPU: the port's quantizers and
label hash are bit-equal to the JAX package's (grid edges and a hash that
wraps included), its quantized index is field-equal, and the scalar and
batched probes return the reference's rows with the sidecar on and off."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import GnnPeConfig as RefConfig  # noqa: E402
from repro.core import GnnPeEngine as RefEngine  # noqa: E402
from repro.core import index as RI  # noqa: E402
from repro.graphs import erdos_renyi, random_connected_query  # noqa: E402
from repro_torch.convert import partition_state_from_reference  # noqa: E402
from repro_torch.core import GnnPeConfig, GnnPeEngine, vf2_match  # noqa: E402
from repro_torch.core import index as PI  # noqa: E402
from repro_torch.graphs import Graph  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def edge_values(seed: int) -> np.ndarray:
    """float32 values on and around every grid edge k/250, at 0 and 1, below
    0, above 1, and seeded ones in and beyond (0, 1)."""
    rng = np.random.default_rng(seed)
    grid = (np.arange(-2, 253) / 250.0).astype(np.float32)
    out = [
        grid,
        np.nextafter(grid, np.float32(np.inf)),
        np.nextafter(grid, np.float32(-np.inf)),
        np.float32([0.0, -0.0, 1.0, -1e-8, 1 + 1e-7, 2.0, -3.5, 7.0, 1e6, np.inf, -np.inf]),
        rng.random(4000, dtype=np.float32),
        rng.normal(0.5, 2.0, 4000).astype(np.float32),
    ]
    return np.concatenate(out).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantizers_bit_equal_to_reference(seed):
    x = edge_values(seed)
    for port_fn, ref_fn in ((PI.quantize_data, RI.quantize_data),
                            (PI.quantize_query, RI.quantize_query)):
        got = port_fn(_t(x))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), ref_fn(x))
    # 2-D, as the index and the probe call them
    x2 = x[: 18 * 200].reshape(200, 18)
    np.testing.assert_array_equal(PI.quantize_data(_t(x2)).numpy(), RI.quantize_data(x2))
    # a grid edge queried with q == e is never dismissed (floor ≤ ceil)
    grid = (np.arange(0, 251) / 250.0).astype(np.float32)
    assert bool((PI.quantize_query(_t(grid)) <= PI.quantize_data(_t(grid))).all())


@pytest.mark.parametrize("L", [1, 3, 4, 6, 9])
def test_hash_labels_bit_equal_to_reference(L):
    rng = np.random.default_rng(L)
    labels = rng.integers(0, 1 << 20, (500, L)).astype(np.int32)
    labels[:3] = labels[3]  # equal sequences hash equal
    with np.errstate(over="ignore"):
        want = RI.hash_labels(labels)
    got = PI.hash_labels(_t(labels))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(got[:4].tolist())) == 1
    exact = [0] * labels.shape[0]
    for j in range(L):
        exact = [h * 1_000_003 + int(v) + 1 for h, v in zip(exact, labels[:, j])]
    wrapped = [((h + (1 << 63)) % (1 << 64)) - (1 << 63) for h in exact]
    assert got.tolist() == wrapped
    if L >= 4:  # the hash wraps mod 2⁶⁴ at this length
        assert any(h != w for h, w in zip(exact, wrapped))


def make_index_inputs(P: int, D: int, n_multi: int, seed: int, on_grid: bool = False):
    """Seeded path embeddings whose label rows follow the path's vertices'
    labels ``vlab``, so a sorted index's label sequences are vlab[paths]."""
    rng = np.random.default_rng(seed)
    L = D // 2
    emb = rng.random((P, D), dtype=np.float32)
    if on_grid:
        emb = (rng.integers(0, 251, (P, D)) / 250.0).astype(np.float32)
    emb[rng.random(P) < 0.05] = 1.0
    vlab = rng.integers(0, 4, 100).astype(np.int32)
    paths = rng.integers(0, 100, (P, L)).astype(np.int32)
    lab_ids = vlab[paths]
    emb0 = rng.random((4, 2)).astype(np.float32)[lab_ids].reshape(P, D)
    emb_multi = rng.random((n_multi, P, D), dtype=np.float32)
    return paths, emb, emb0, emb_multi, vlab


def build_both(P, D, n_multi, seed, quantize=True, block_size=32, fanout=4, on_grid=False):
    paths, emb, emb0, emb_multi, lab = make_index_inputs(P, D, n_multi, seed, on_grid)
    ref = RI.build_index(
        paths, emb, emb0, emb_multi, block_size=block_size, fanout=fanout,
        quantize=quantize, path_labels=lab[paths] if quantize else None,
    )
    port = PI.build_index(
        _t(paths.astype(np.int64)), _t(emb), _t(emb0), _t(emb_multi),
        block_size=block_size, fanout=fanout, quantize=quantize,
        path_labels=_t(lab[paths].astype(np.int64)) if quantize else None,
    )
    return ref, port, lab


@pytest.mark.parametrize("n_multi", [0, 2])
@pytest.mark.parametrize("quantize", [False, True])
def test_quantized_index_fields_equal_reference(n_multi, quantize):
    ref, port, _ = build_both(1500, 6, n_multi, seed=3 + n_multi, quantize=quantize)
    np.testing.assert_array_equal(port.paths.numpy(), ref.paths)
    if quantize:
        assert port.emb_q.dtype == torch.int8 and port.label_hash.dtype == torch.int64
        np.testing.assert_array_equal(port.emb_q.numpy(), ref.emb_q)
        np.testing.assert_array_equal(port.label_hash.numpy(), ref.label_hash)
    else:
        assert port.emb_q is None and port.label_hash is None
    assert port.nbytes() == ref.nbytes()


def _queries(ref, vlab, Q: int, seed: int):
    """Queries shrunk from index rows (so they hit), the label hashes of
    those rows' sequences, and two random queries."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, ref.n_paths, Q)
    scale = rng.uniform(0.7, 1.0, (Q, 1)).astype(np.float32)
    q_emb = (ref.emb[rows] * scale).astype(np.float32)
    q_emb0 = ref.emb0[rows].copy()
    q_multi = (ref.emb_multi[:, rows] * scale[None]).astype(np.float32)
    q_emb[Q - 2 :] = rng.random((2, ref.emb.shape[1]), dtype=np.float32)
    return q_emb, q_emb0, q_multi, rows, RI.hash_labels(vlab[ref.paths[rows]])


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("on_grid", [False, True])
def test_query_index_rows_equal_reference(quantize, on_grid):
    """The scalar probe: the reference's rows and stats, query by query;
    on the grid, a query equal to an index row keeps that row."""
    ref, port, vlab = build_both(800, 6, 2, seed=11, quantize=quantize, on_grid=on_grid)
    q_emb, q_emb0, q_multi, rows, hashes = _queries(ref, vlab, 12, seed=5)
    if on_grid:
        q_emb[:4] = ref.emb[rows[:4]]  # q == e on grid edges
        q_multi[:, :4] = ref.emb_multi[:, rows[:4]]
    n_hits = 0
    for qi in range(q_emb.shape[0]):
        qh = int(hashes[qi]) if quantize else None
        want, wst = RI.query_index(
            ref, q_emb[qi], q_emb0[qi], q_multi[:, qi], q_label_hash=qh, return_stats=True
        )
        got, gst = PI.query_index(
            port, _t(q_emb[qi]), _t(q_emb0[qi]), _t(q_multi[:, qi]), q_label_hash=qh,
            return_stats=True,
        )
        np.testing.assert_array_equal(got.numpy(), want)
        assert gst == wst
        if on_grid and qi < 4:
            assert rows[qi] in set(got.tolist()), "a grid-edge row equal to the query was lost"
        n_hits += int(want.size > 0)
    assert n_hits >= 8


@pytest.mark.parametrize("quantize", [False, True])
def test_batched_probe_rows_equal_reference_and_scalar(quantize, monkeypatch):
    """query_index_batch_multi over three partitions with label hashes: the
    reference's rows and stats, the pair counter before the prefilter,
    and per query the port's own scalar probe.  The prefilter hands the
    verdict fewer pairs than the descent found."""
    verdict_pairs = []
    keep_mask = PI._pairs_keep_mask
    monkeypatch.setattr(
        PI, "_pairs_keep_mask",
        lambda *a: verdict_pairs.append(sum(s.rows.numel() for s in a[0])) or keep_mask(*a),
    )
    parts = [build_both(600 + 150 * s, 6, 2, seed=20 + s, quantize=quantize) for s in range(3)]
    ref_items, items, hashes = [], [], []
    for s, (ref, port, vlab) in enumerate(parts):
        q_emb, q_emb0, q_multi, rows, qh = _queries(ref, vlab, 10 + s, seed=s)
        qh = qh if quantize else None
        ref_items.append((ref, q_emb, q_emb0, q_multi, qh))
        items.append((port, _t(q_emb), _t(q_emb0), _t(q_multi), _t(qh) if quantize else None))
        hashes.append(qh)
    RI.reset_pair_counters()
    want, want_stats = RI.query_index_batch_multi(ref_items, use_pallas=False, return_stats=True)
    ref_pairs = RI.PAIR_COUNTERS["leaf_pairs"]
    PI.reset_pair_counters()
    got, got_stats = PI.query_index_batch_multi(items, return_stats=True)
    assert PI.PAIR_METRIC.get(kind="leaf_pairs") == ref_pairs > 0
    assert len(verdict_pairs) == 1
    assert (verdict_pairs[0] < ref_pairs) == quantize
    assert got_stats == want_stats
    n_hits = 0
    for (port, q_emb, q_emb0, q_multi, _), qh, w_part, g_part in zip(items, hashes, want, got):
        for qi, (w, g) in enumerate(zip(w_part, g_part)):
            np.testing.assert_array_equal(g.numpy(), w)
            scalar = PI.query_index(
                port, q_emb[qi], q_emb0[qi], q_multi[:, qi],
                q_label_hash=int(qh[qi]) if quantize else None,
            )
            np.testing.assert_array_equal(scalar.numpy(), w)
            n_hits += int(w.size > 0)
    assert n_hits > 10


@pytest.fixture(scope="module")
def quantized_engines():
    g = erdos_renyi(150, avg_degree=3.5, n_labels=5, seed=3)
    cfg = dict(n_partitions=2, encoder="monotone", quantize_index=True, block_size=32)
    ref = RefEngine(RefConfig(**cfg)).build(g)
    port = GnnPeEngine(GnnPeConfig(**cfg), device="cpu").build(
        Graph(g.offsets, g.nbrs, g.labels), params=partition_state_from_reference(ref.models)
    )
    plain = GnnPeEngine(GnnPeConfig(**dict(cfg, quantize_index=False)), device="cpu").build(
        Graph(g.offsets, g.nbrs, g.labels), params=partition_state_from_reference(ref.models)
    )
    return g, ref, port, plain


def test_engine_sidecar_equals_reference(quantized_engines):
    """The engine hashes each path's labels on its device: every partition's
    sidecar equals the reference's, and so do the index bytes."""
    _, ref, port, _ = quantized_engines
    for rm, pm in zip(ref.models, port.models):
        np.testing.assert_array_equal(pm.index.emb_q.numpy(), rm.index.emb_q)
        np.testing.assert_array_equal(pm.index.label_hash.numpy(), rm.index.label_hash)
    assert port.offline_stats["index_bytes"] == ref.offline_stats["index_bytes"]
    side = sum(m.index.emb_q.numel() + 8 * m.index.label_hash.numel() for m in port.models)
    full = sum(
        4 * (m.index.emb.numel() + m.index.emb0.numel() + m.index.emb_multi.numel())
        for m in port.models
    )
    assert side * 3 < full  # 26 bytes a path against 96 (n_multi = 2, l = 2, d = 2)


@pytest.mark.parametrize("join_impl", ["numpy", "device"])
def test_engine_quantized_lists_equal_reference(quantized_engines, join_impl):
    g, ref, port, plain = quantized_engines
    qs = [random_connected_query(g, 5, seed=700 + s) for s in range(5)]
    got = port.match_many(qs, join_impl=join_impl)
    assert got == ref.match_many(qs, join_impl=join_impl)
    pg = Graph(g.offsets, g.nbrs, g.labels)
    for q, m, b in zip(qs, got, plain.match_many(qs, join_impl=join_impl)):
        assert set(m) == set(vf2_match(pg, q)) == set(b)
    assert sum(map(len, got)) > 0
