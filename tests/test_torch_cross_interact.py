"""K5, the fused DCN-v2 cross layer: the port's plain version and its CPU
wrapper path against the JAX package's reference, its Pallas kernel
(interpret mode) and the model's ``_cross_layer``, within rtol = atol =
1e-4 (the JAX package's own tolerance: the GEMM's summation order
differs).  The CUDA kernel itself is held against the plain version on
the card (``test_torch_cuda.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.cross_interact.ops import cross_interact as jax_cross  # noqa: E402
from repro.kernels.cross_interact.ref import cross_interact_ref as jax_ref  # noqa: E402
from repro.models.recsys import _cross_layer as jax_layer  # noqa: E402
from repro_torch.kernels.cross_interact import ops  # noqa: E402
from repro_torch.kernels.cross_interact.ref import cross_interact_ref, make_cross  # noqa: E402
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
