"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a card these tests skip (a CUDA kernel has no
CPU mode).  The file imports neither JAX nor the JAX package, so it runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.dominance_scan import ops  # noqa: E402
from repro_torch.kernels.dominance_scan.ref import dominance_scan_pairs_ref, make_pairs  # noqa: E402


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
def test_empty_batch_launches_nothing(cuda):
    args = [torch.from_numpy(a).to(cuda) for a in make_pairs(0, seed=0)]
    before = ops.LAUNCHES
    assert ops.dominance_scan_pairs(*args).shape == (0,)
    assert ops.LAUNCHES == before
