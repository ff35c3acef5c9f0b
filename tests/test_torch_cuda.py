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
    dominance_scan_batch_ref,
    dominance_scan_pairs_ref,
    dominance_scan_ref,
    make_pairs,
    make_scan,
)
from repro_torch.kernels.merge_join import ops as mj  # noqa: E402
from repro_torch.kernels.merge_join.ref import injectivity_mask_ref, make_join_rows  # noqa: E402


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
