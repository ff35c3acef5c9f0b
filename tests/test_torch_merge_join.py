"""The device merge-join ops: the port's wrappers and plain versions give
the JAX package's words, run bounds, pair expansions, injectivity
verdicts (bit-equal to its reference and to its Pallas kernel in
interpret mode) and dedup masks on the same seeded inputs.  The CUDA
kernel K2 itself is held against the plain version on the card
(``test_torch_cuda.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.merge_join import ops as ref_ops  # noqa: E402
from repro.kernels.merge_join import ref as ref_np  # noqa: E402
from repro_torch.kernels.merge_join import ops  # noqa: E402
from repro_torch.kernels.merge_join.ref import (  # noqa: E402
    dedup_mask_ref,
    expand_pairs_ref,
    injectivity_mask_ref,
    join_layouts,
    make_join_rows,
    pack_words_ref,
    run_bounds_ref,
)


def _rows(R: int, C: int, bits: int, seed: int) -> np.ndarray:
    """Seeded rows with ids up to 2**bits − 1 and repeated rows."""
    rng = np.random.default_rng(seed)
    hi = 2**bits
    rows = rng.integers(0, hi, (R, C), dtype=np.int64)
    rows[: R // 8] = hi - 1 - rng.integers(0, min(hi, 3), (R // 8, C))  # top bits set
    rows[R // 2 : R // 2 + R // 8] = rows[: R // 8]  # duplicates
    return rows.astype(np.int32)


def _sorted_words(words: np.ndarray) -> np.ndarray:
    return words[np.lexsort(tuple(words[:, k] for k in range(words.shape[1] - 1, -1, -1)))]


@pytest.mark.parametrize("bits", [1, 5, 16, 17, 31])
@pytest.mark.parametrize("C", range(1, 9))
def test_pack_words_equal_reference(bits, C):
    """Words equal the reference's op and oracle; C·bits crosses 31 and 62
    bit word boundaries at several of these (straddling columns)."""
    rows = _rows(97, C, bits, seed=bits * 10 + C)
    want = ref_np.pack_words_ref(rows, bits)
    np.testing.assert_array_equal(np.asarray(ref_ops.pack_words(jnp.asarray(rows), bits)), want)
    np.testing.assert_array_equal(ops.pack_words(torch.from_numpy(rows), bits).numpy(), want)
    np.testing.assert_array_equal(pack_words_ref(torch.from_numpy(rows), bits).numpy(), want)
    assert want.shape[1] == ops.key_words(C, bits)
    # a batch axis packs each member alike
    batched = ops.pack_words(torch.from_numpy(np.stack([rows, rows[::-1]])), bits).numpy()
    np.testing.assert_array_equal(batched[0], want)
    np.testing.assert_array_equal(batched[1], want[::-1])


@pytest.mark.parametrize("C,bits", [(1, 9), (3, 12), (4, 17), (8, 31)])
def test_lex_order_run_bounds_run_lookup_equal_reference(C, bits):
    rows = _rows(160, C, bits, seed=C)
    words = ref_np.pack_words_ref(rows, bits)
    want_order = np.asarray(ref_ops.lex_order(jnp.asarray(words)))
    np.testing.assert_array_equal(ops.lex_order(torch.from_numpy(words)).numpy(), want_order)
    sw = _sorted_words(words)
    rng = np.random.default_rng(C)
    probe = np.concatenate([words[rng.integers(0, 160, 40)], ref_np.pack_words_ref(
        _rows(8, C, bits, seed=99), bits)])  # hits and (mostly) misses
    lo_r, hi_r = ref_np.run_bounds_ref(sw, probe)
    for fn, ref_fn in ((ops.run_bounds, ref_ops.run_bounds), (ops.run_lookup, ref_ops.run_lookup)):
        lo, hi = fn(torch.from_numpy(sw), torch.from_numpy(probe))
        lo_j, hi_j = ref_fn(jnp.asarray(sw), jnp.asarray(probe))
        for got, want, jx in ((lo, lo_r, lo_j), (hi, hi_r, hi_j)):
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(got.numpy(), np.asarray(jx))
    lo_p, hi_p = run_bounds_ref(torch.from_numpy(sw), torch.from_numpy(probe))
    np.testing.assert_array_equal(lo_p.numpy(), lo_r)
    np.testing.assert_array_equal(hi_p.numpy(), hi_r)
    assert (hi_r > lo_r).any() and (hi_r == lo_r).any()


@pytest.mark.parametrize("slack", [0, 1, 37])
def test_expand_pairs_equal_reference(slack):
    rng = np.random.default_rng(slack)
    lo = rng.integers(0, 50, 64)
    hi = lo + rng.integers(0, 4, 64) * (rng.random(64) < 0.7)
    total = int((hi - lo).sum())
    cap = total + slack
    r_w, c_w, v_w = ref_np.expand_pairs_ref(lo, hi, cap)
    for fn in (ops.expand_pairs, expand_pairs_ref):
        r, c, v = fn(torch.from_numpy(lo), torch.from_numpy(hi), cap)
        np.testing.assert_array_equal(r.numpy(), r_w)
        np.testing.assert_array_equal(c.numpy(), c_w)
        np.testing.assert_array_equal(v.numpy(), v_w)
    # the reference's jnp op agrees on the valid rows (its padding differs)
    r_j, c_j, v_j = (np.asarray(a) for a in ref_ops.expand_pairs(
        jnp.asarray(lo, jnp.int32), jnp.asarray(hi, jnp.int32), cap))
    np.testing.assert_array_equal(v_j, v_w)
    np.testing.assert_array_equal(r_j[v_j], r_w[v_w])
    np.testing.assert_array_equal(c_j[v_j], c_w[v_w])


def test_expand_pairs_batched_and_truncated():
    """Members expand independently; a cap below a member's total keeps
    its first cap pairs (the caller sees the total and runs again)."""
    lo = torch.tensor([[0, 3, 3, 7], [1, 1, 1, 1]])
    hi = torch.tensor([[2, 3, 6, 8], [4, 1, 2, 1]])
    r, c, v = ops.expand_pairs(lo, hi, 5)
    assert r.tolist() == [[0, 0, 2, 2, 2], [0, 0, 0, 2, 0]]
    assert c.tolist() == [[0, 1, 3, 4, 5], [1, 2, 3, 1, 0]]
    assert v.tolist() == [[True] * 5, [True] * 4 + [False]]


@pytest.mark.parametrize("T", [0, 1, 37, 2053])
@pytest.mark.parametrize("Co,Cn", [(7, 1), (5, 2), (0, 3), (3, 0)])
def test_injectivity_mask_equal_reference_and_pallas(T, Co, Cn):
    old, new = make_join_rows(T, Co, Cn, seed=T + 10 * Co + Cn)
    want = ref_np.injectivity_mask_ref(old, new)
    if T:
        # the Pallas kernel in interpret mode, as the reference's own tests
        # run it; its block spec cannot take Co = 0, so that width is held
        # against the reference's jnp form
        jx = ref_ops.injectivity_mask(
            jnp.asarray(old), jnp.asarray(new), use_pallas=Co > 0, interpret=True
        )
        np.testing.assert_array_equal(np.asarray(jx), want)
    before = ops.LAUNCHES
    got = ops.injectivity_mask(torch.from_numpy(old), torch.from_numpy(new))
    assert ops.LAUNCHES == before, "no kernel launch may be counted for CPU tensors"
    assert got.dtype == torch.bool and got.shape == (T,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        injectivity_mask_ref(torch.from_numpy(old), torch.from_numpy(new)).numpy(), want
    )
    if T >= 37 and Cn:
        assert 0 < want.sum() < T  # both verdicts occur


def test_injectivity_mask_takes_strided_column_slices():
    """The join hands in the old and new column slices of one table."""
    old, new = make_join_rows(301, 4, 2, seed=5)
    table = torch.from_numpy(np.concatenate([old, new], axis=1))
    got = ops.injectivity_mask(table[:, :4], table[:, 4:])
    np.testing.assert_array_equal(got.numpy(), ref_np.injectivity_mask_ref(old, new))
    with pytest.raises(TypeError):
        ops.injectivity_mask(table[:, :4].long(), table[:, 4:].long())
    with pytest.raises(ValueError):
        ops.injectivity_mask(table[:4], table[:, 4:])


@pytest.mark.parametrize("T", [3, 4, 5, 37])
@pytest.mark.parametrize("Co,Cn", [(1, 1), (8, 8), (15, 1), (9, 8), (56, 8)])
def test_injectivity_mask_edge_widths(T, Co, Cn):
    """The widths K2 takes distinct paths for (W = 2, 16 in registers, 17
    and 64 at the runtime width) and T that is no multiple of 4, on seeded
    rows and on rows of all sentinels, against the Pallas kernel in
    interpret mode and the reference's NumPy form."""
    for old, new in (make_join_rows(T, Co, Cn, seed=T + Co),
                     make_join_rows(T, Co, Cn, seed=0, all_sentinels=True)):
        want = ref_np.injectivity_mask_ref(old, new)
        jx = ref_ops.injectivity_mask(jnp.asarray(old), jnp.asarray(new), use_pallas=True,
                                      interpret=True)
        np.testing.assert_array_equal(np.asarray(jx), want)
        got = ops.injectivity_mask(torch.from_numpy(old), torch.from_numpy(new))
        np.testing.assert_array_equal(got.numpy(), want)
    assert want.all()  # the sentinels never collide
    np.testing.assert_array_equal(
        injectivity_mask_ref(torch.from_numpy(old), torch.from_numpy(new)).numpy(), want)


@pytest.mark.parametrize("T,Co,Cn", [(1, 6, 1), (5, 6, 1), (37, 0, 3), (37, 15, 1), (37, 56, 8)])
def test_injectivity_layout(T, Co, Cn):
    """The wrapper's layout decision is a function of shapes, strides and
    pointers: the column slices of one contiguous table (at any base) are
    contiguous, separate tensors (but new alone at Co = 0) and a wider
    parent table strided; every layout gives the plain verdict."""
    old, new = (torch.from_numpy(a) for a in make_join_rows(T, Co, Cn, seed=T))
    want = ref_np.injectivity_mask_ref(old.numpy(), new.numpy())
    cases = join_layouts(old, new)
    assert [c[2] for c in cases.values()] == ["contiguous"] * 3 + [
        "contiguous" if Co == 0 else "strided", "strided"]
    for a, b, layout in cases.values():
        assert ops.injectivity_layout(a, b) == layout
        np.testing.assert_array_equal(ops.injectivity_mask(a, b).numpy(), want)
    flat = torch.cat([old, new], 1)
    assert ops.injectivity_layout(flat[:, :Co], flat[:, Co:]) == "contiguous"
    if T > 1:  # a row stride other than the table's width
        assert ops.injectivity_layout(flat[::2, :Co], flat[::2, Co:]) == "strided"


@pytest.mark.parametrize("what", ["new columns", "all columns", "old column stride",
                                  "new column stride"])
def test_injectivity_layout_refuses(what):
    """Widths past the kernel's bounds and columns that are not unit-stride
    are refused before any launch."""
    t = torch.zeros((6, 80), dtype=torch.int32)
    old, new = {
        "new columns": (t[:, :4], t[:, 4:13]),
        "all columns": (t[:, :60], t[:, 60:65]),
        "old column stride": (t[:, 0:8:2], t[:, 8:10]),
        "new column stride": (t[:, :4], t[:, 4:8:2]),
    }[what]
    with pytest.raises(ValueError):
        ops.injectivity_layout(old, new)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dedup_mask_equal_reference(seed):
    rng = np.random.default_rng(seed)
    rows = _rows(200, 3, 11, seed=seed)
    words = ref_np.pack_words_ref(rows, 11)
    valid = rng.random(200) > 0.25
    o_w, k_w = ref_np.dedup_mask_ref(words, valid)
    for fn in (ops.dedup_mask, dedup_mask_ref):
        o, k = fn(torch.from_numpy(words), torch.from_numpy(valid))
        np.testing.assert_array_equal(o.numpy(), o_w)
        np.testing.assert_array_equal(k.numpy(), k_w)
    o_j, k_j = ref_ops.dedup_mask(jnp.asarray(words), jnp.asarray(valid))
    np.testing.assert_array_equal(np.asarray(o_j), o_w)
    np.testing.assert_array_equal(np.asarray(k_j), k_w)
    assert k_w.sum() < valid.sum()  # duplicates were dropped
