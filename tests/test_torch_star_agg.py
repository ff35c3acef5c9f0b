"""K4, the masked gather-sum (EmbeddingBag, sum): the port's plain version
and its CPU wrapper path against the JAX package's reference and its
Pallas kernel (interpret mode).  Single-hot bags are row copies and
bit-equal; multi-hot sums agree within float32 rounding (rtol = atol =
1e-5, the JAX package's own tolerance for this kernel).  The CUDA kernel
itself is held against the plain version on the card
(``test_torch_cuda.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.star_agg.ops import star_agg as jax_star_agg  # noqa: E402
from repro.kernels.star_agg.ref import star_agg_ref as jax_ref  # noqa: E402
from repro_torch.kernels.star_agg import ops  # noqa: E402
from repro_torch.kernels.star_agg.ref import make_bags, star_agg_ref  # noqa: E402


def _torch(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


@pytest.mark.parametrize("n,k,v,f", [(64, 4, 16, 8), (1000, 10, 64, 32), (333, 7, 128, 128)])
def test_plain_version_matches_reference_and_pallas_kernel(n, k, v, f):
    rng = np.random.default_rng(n * k)
    idx = rng.integers(0, v, (n, k)).astype(np.int32)
    mask = rng.random((n, k)) < 0.7
    table = rng.normal(size=(v, f)).astype(np.float32)
    got = star_agg_ref(*_torch(idx, mask, table))
    assert got.dtype == torch.float32 and got.shape == (n, f)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_ref(idx, mask, table)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_star_agg(idx, mask, table)),
                               rtol=1e-5, atol=1e-5)
    before = ops.LAUNCHES
    assert torch.equal(ops.star_agg(*_torch(idx, mask, table)), got)
    assert ops.LAUNCHES == before  # a CPU tensor takes the plain version


@pytest.mark.parametrize("n,v,f", [(1, 5, 16), (517, 300, 16), (64, 7, 6)])
def test_single_hot_is_a_bit_equal_row_copy(n, v, f):
    rng = np.random.default_rng(n + v)
    idx = rng.integers(0, v, (n, 1)).astype(np.int32)
    mask = np.ones((n, 1), bool)
    table = rng.normal(size=(v, f)).astype(np.float32)
    got = ops.star_agg(*_torch(idx, mask, table)).numpy()
    np.testing.assert_array_equal(got, table[idx[:, 0]])
    np.testing.assert_array_equal(got, np.asarray(jax_ref(idx, mask, table)))
    np.testing.assert_array_equal(got, np.asarray(jax_star_agg(idx, mask, table)))


@pytest.mark.parametrize("n,k", [(1, 8), (200, 8), (97, 3)])
def test_masked_slots_with_junk_ids_contribute_nothing(n, k):
    """Masked slots hold −1 or ids past V, and row 0 is fully masked."""
    idx, mask, table = make_bags(n, k, 40, 16, seed=n)
    got = ops.star_agg(*_torch(idx, mask, table)).numpy()
    np.testing.assert_array_equal(got[0], 0.0)
    want = np.where(mask[..., None], table[np.where(mask, idx, 0)], 0).sum(1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the JAX reference clamps the junk ids it gathers, then multiplies by 0
    jax_out = jax_ref(jnp.asarray(idx), jnp.asarray(mask), jnp.asarray(table))
    np.testing.assert_allclose(got, np.asarray(jax_out), rtol=1e-5, atol=1e-5)


def test_all_masked_and_empty():
    table = torch.ones((4, 8))
    out = ops.star_agg(torch.zeros((16, 3), dtype=torch.int32),
                       torch.zeros((16, 3), dtype=torch.bool), table)
    assert torch.equal(out, torch.zeros((16, 8)))
    empty = ops.star_agg(torch.zeros((0, 3), dtype=torch.int32),
                         torch.zeros((0, 3), dtype=torch.bool), table)
    assert empty.shape == (0, 8)


@pytest.mark.parametrize("bad,err", [
    ("idx_int64", TypeError), ("mask_int", TypeError), ("table_f64", TypeError),
    ("mask_shape", ValueError), ("idx_1d", ValueError), ("strided", ValueError),
    ("meta", ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    idx = torch.zeros((6, 2), dtype=torch.int32)
    mask = torch.ones((6, 2), dtype=torch.bool)
    table = torch.ones((5, 4))
    if bad == "idx_int64":
        idx = idx.long()
    elif bad == "mask_int":
        mask = mask.int()
    elif bad == "table_f64":
        table = table.double()
    elif bad == "mask_shape":
        mask = mask[:, :1].contiguous()
    elif bad == "idx_1d":
        idx, mask = idx[:, 0].contiguous(), mask[:, 0].contiguous()
    elif bad == "strided":
        table = torch.ones((5, 8))[:, ::2]
    elif bad == "meta":
        idx, mask, table = (t.to("meta") for t in (idx, mask, table))
    with pytest.raises(err):
        ops.star_agg(idx, mask, table)
