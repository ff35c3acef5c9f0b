"""K5, the fused DCN-v2 cross layer: the port's plain version and its CPU
wrapper path against the JAX package's reference, its Pallas kernel
(interpret mode) and the model's ``_cross_layer``, within rtol = atol =
1e-4 (the JAX package's own tolerance: the GEMM's summation order
differs).  The CUDA kernel itself is held against the plain version on
the card (``test_torch_cuda.py``); here a plain model of its 3xTF32
arithmetic (``ref.cross_interact_tf32_model``) is held to the same
tolerance, and a one-pass TF32 model must fail it."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.cross_interact.ops import cross_interact as jax_cross  # noqa: E402
from repro.kernels.cross_interact.ref import cross_interact_ref as jax_ref  # noqa: E402
from repro.models.recsys import _cross_layer as jax_layer  # noqa: E402
from repro_torch.kernels.cross_interact import ops  # noqa: E402
from repro_torch.kernels.cross_interact.ref import (  # noqa: E402
    cross_interact_ref,
    cross_interact_tf32_model,
    make_cross,
    tf32_round,
)
from repro_torch.models.recsys import _cross_layer  # noqa: E402


@pytest.mark.parametrize("b,d", [(64, 32), (512, 429), (1000, 128), (1, 429), (9, 13)])
def test_plain_version_matches_reference_and_pallas_kernel(b, d):
    arrs = make_cross(b, d, seed=b + d)
    got = cross_interact_ref(*(torch.from_numpy(a) for a in arrs)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_ref(*arrs)), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jax_cross(*arrs)), rtol=1e-4, atol=1e-4)
    before = ops.LAUNCHES
    out = ops.cross_interact(*(torch.from_numpy(a) for a in arrs))
    assert ops.LAUNCHES == before  # a CPU tensor takes the plain version
    np.testing.assert_array_equal(out.numpy(), got)


@pytest.mark.parametrize("b,d", [(32, 16), (8, 429)])
def test_model_cross_layer_matches_reference_layer(b, d):
    arrs = make_cross(b, d, seed=3 + d)
    want = jax_layer(*(jnp.asarray(a) for a in arrs))
    got = _cross_layer(*(torch.from_numpy(a) for a in arrs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bad,err", [
    ("f64", TypeError), ("w_shape", ValueError), ("b_shape", ValueError),
    ("x0_shape", ValueError), ("strided", ValueError), ("meta", ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    x0, x, w, b = (torch.from_numpy(a) for a in make_cross(4, 6, seed=0))
    if bad == "f64":
        x = x.double()
    elif bad == "w_shape":
        w = w[:5].contiguous()
    elif bad == "b_shape":
        b = b[:5].contiguous()
    elif bad == "x0_shape":
        x0 = x0[:3].contiguous()
    elif bad == "strided":
        w = w.T
    elif bad == "meta":
        x0, x, w, b = (t.to("meta") for t in (x0, x, w, b))
    with pytest.raises(err):
        ops.cross_interact(x0, x, w, b)


def test_tf32_round_keeps_ten_mantissa_bits_rounding_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0**-10  # tf32's unit in the last place at 1
    t = torch.tensor([one + ulp / 2, one + ulp / 2 - 2.0**-23, -(one + ulp / 2), one + 1.5 * ulp,
                      one + 3 * ulp / 4, 0.0, -0.0, float("inf")], dtype=torch.float32)
    want = [one + ulp, one, -(one + ulp), one + 2 * ulp, one + ulp, 0.0, -0.0, float("inf")]
    got = tf32_round(t)
    assert got.tolist() == want  # ties go away from zero, as cvt.rna does
    assert torch.signbit(got[6])
    x = torch.from_numpy(np.random.default_rng(0).normal(size=100_000).astype(np.float32))
    x = x * torch.exp2(torch.randint(-60, 60, x.shape).float())
    r = tf32_round(x)
    assert bool(((r.view(torch.int32) & 0x1FFF) == 0).all())  # the 13 low bits are clear
    assert bool(((r - x).abs() <= 2.0**-11 * x.abs()).all())  # half a tf32 ulp at most


def test_big_plus_small_reconstructs_each_operand():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=100_000).astype(np.float32))
    x = x * torch.exp2(torch.randint(-60, 60, x.shape).float())
    big = tf32_round(x)
    small = tf32_round(x - big)
    assert bool(((small.view(torch.int32) & 0x1FFF) == 0).all())
    err = (big.double() + small.double() - x.double()).abs()
    assert bool((err <= 2.0**-21 * x.double().abs()).all())


@pytest.mark.parametrize("b,d", [(512, 429), (1, 429), (9, 13), (64, 432)])
def test_three_pass_model_meets_the_float32_tolerance(b, d):
    arrs = make_cross(b, d, seed=b + d)
    got = cross_interact_tf32_model(*(torch.from_numpy(a) for a in arrs)).numpy()
    want = cross_interact_ref(*(torch.from_numpy(a) for a in arrs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jax_ref(*arrs)), rtol=1e-4, atol=1e-4)


def test_one_pass_model_fails_the_float32_tolerance():
    """The tolerance tells the 3xTF32 design from a single TF32 pass."""
    arrs = [torch.from_numpy(a) for a in make_cross(512, 429, seed=941)]
    want = cross_interact_ref(*arrs)
    got = cross_interact_tf32_model(*arrs, passes=1)
    assert not torch.allclose(got, want, rtol=1e-4, atol=1e-4)
    assert float((got - want).abs().max()) > 1e-3
