"""K1-pairs, the fused dominance verdict: the port's plain version and its
CPU wrapper path are bit-equal to the JAX package's reference and to its
Pallas kernel (interpret mode), ties at eps and +inf rows included.  The
CUDA kernel itself is held against the plain version on the card
(``test_torch_cuda.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.dominance_scan.kernel import dominance_scan_pairs_pallas  # noqa: E402
from repro.kernels.dominance_scan.ops import dominance_scan_pairs as jax_pairs  # noqa: E402
from repro.kernels.dominance_scan.ref import dominance_scan_pairs_ref as jax_ref  # noqa: E402
from repro_torch.kernels.dominance_scan import ops  # noqa: E402
from repro_torch.kernels.dominance_scan.ref import dominance_scan_pairs_ref, make_pairs  # noqa: E402

EPS32 = np.float32(1e-6)


def _torch(arrs):
    return [torch.from_numpy(a.copy()) for a in arrs]


@pytest.mark.parametrize("T", [0, 1, 7, 1037])
def test_plain_version_bit_equal_to_reference(T):
    arrs = make_pairs(T, seed=T)
    want = np.asarray(jax_ref(*arrs, eps=1e-6)).astype(bool)
    got = dominance_scan_pairs_ref(*_torch(arrs), eps=1e-6).numpy()
    np.testing.assert_array_equal(got, want)
    # the JAX wrapper (padding, bucketing) agrees with its own reference too
    np.testing.assert_array_equal(np.asarray(jax_pairs(*arrs, eps=1e-6)).astype(bool), want)
    if T:
        assert 0 < want.sum() < T or T == 1


@pytest.mark.parametrize("T", [1, 1037])
def test_cpu_wrapper_bit_equal_to_pallas_interpret(T):
    arrs = make_pairs(T, seed=100 + T)
    want = np.asarray(dominance_scan_pairs_pallas(*arrs, block_t=T, eps=1e-6, interpret=True))
    before = ops.LAUNCHES
    got = ops.dominance_scan_pairs(*_torch(arrs), eps=1e-6)
    assert got.dtype == torch.bool and got.shape == (T,)
    np.testing.assert_array_equal(got.numpy(), want.astype(bool))
    assert ops.LAUNCHES == before, "no kernel launch may be counted for CPU tensors"


def test_ties_decide_as_the_reference():
    e = np.float32([[0.5, 0.25]])
    q0 = np.zeros((1, 1), np.float32)
    cases = [
        (e + EPS32, True),  # exactly at the tie
        (np.nextafter(e + EPS32, np.float32(1)), False),
        (np.nextafter(e + EPS32, np.float32(0)), True),
    ]
    for q, keep in cases:
        arrs = [q.astype(np.float32), q0, e, q0]
        assert bool(np.asarray(jax_ref(*arrs))[0]) is keep
        assert bool(ops.dominance_scan_pairs(*_torch(arrs))[0]) is keep


def test_wrapper_rejects_bad_operands():
    qg, q0g, eg, e0g = _torch(make_pairs(8, seed=1))
    with pytest.raises(TypeError):
        ops.dominance_scan_pairs(qg.double(), q0g, eg, e0g)
    with pytest.raises(ValueError):
        ops.dominance_scan_pairs(qg[:, :5], q0g, eg, e0g)
    with pytest.raises(ValueError):
        ops.dominance_scan_pairs(qg.t().contiguous().t(), q0g, eg, e0g)


# ---- K3: the dense scans (one query, and Q queries × N rows) -------------

from repro.kernels.dominance_scan.ops import dominance_scan as jax_scan  # noqa: E402
from repro.kernels.dominance_scan.ref import dominance_scan_batch_ref as jax_batch_ref  # noqa: E402
from repro.kernels.dominance_scan.ref import dominance_scan_ref as jax_single_ref  # noqa: E402
from repro_torch.kernels.dominance_scan.ref import (  # noqa: E402
    dominance_scan_batch_ref,
    dominance_scan_ref,
    make_scan,
)


@pytest.mark.parametrize("N", [0, 1, 37, 1037])
@pytest.mark.parametrize("Q", [0, 1, 7])
@pytest.mark.parametrize("D,D0", [(18, 6), (5, 3)])
def test_dense_scans_bit_equal_to_reference(N, Q, D, D0):
    """The batch form (2-D q) and the single form (each q row alone) equal
    the reference's oracle and its Pallas kernels in interpret mode, ties
    at eps, ulps either side, +inf rows and NaNs included (``make_scan``);
    the port returns bool, the reference int32 0/1."""
    q, q0, emb, emb0 = make_scan(Q, N, seed=N + 7 * Q + D, D=D, D0=D0)
    want = np.asarray(jax_batch_ref(q, q0, emb, emb0, eps=1e-6)).astype(bool)
    assert want.shape == (Q, N)
    if Q and N:
        pallas = np.asarray(jax_scan(q, q0, emb, emb0, eps=1e-6, block_n=128, interpret=True))
        np.testing.assert_array_equal(pallas.astype(bool), want)
    tq, tq0, te, te0 = _torch((q, q0, emb, emb0))
    before = (ops.SINGLE_LAUNCHES, ops.BATCH_LAUNCHES)
    got = ops.dominance_scan(tq, tq0, te, te0, eps=1e-6)
    assert got.dtype == torch.bool and got.shape == (Q, N)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(dominance_scan_batch_ref(tq, tq0, te, te0).numpy(), want)
    for k in range(Q):
        single = np.asarray(jax_single_ref(q[k], q0[k], emb, emb0)).astype(bool)
        np.testing.assert_array_equal(single, want[k])
        if N:
            pallas = np.asarray(jax_scan(q[k], q0[k], emb, emb0, block_n=128, interpret=True))
            np.testing.assert_array_equal(pallas.astype(bool), want[k])
        got_k = ops.dominance_scan(tq[k].contiguous(), tq0[k].contiguous(), te, te0)
        assert got_k.shape == (N,)
        np.testing.assert_array_equal(got_k.numpy(), want[k])
        np.testing.assert_array_equal(dominance_scan_ref(tq[k], tq0[k], te, te0).numpy(), want[k])
    assert (ops.SINGLE_LAUNCHES, ops.BATCH_LAUNCHES) == before, "CPU tensors launch nothing"
    if Q == 7 and N == 1037:
        assert 0 < want.sum() < want.size


def test_dense_scan_rejects_bad_operands():
    q, q0, emb, emb0 = _torch(make_scan(3, 40, seed=2))
    with pytest.raises(TypeError):
        ops.dominance_scan(q.double(), q0, emb, emb0)
    with pytest.raises(ValueError):
        ops.dominance_scan(q[:, :5].contiguous(), q0, emb, emb0)
    with pytest.raises(ValueError):
        ops.dominance_scan(q[0].contiguous(), q0[0].contiguous(), emb.t().contiguous().t(), emb0)


def _at_offset(a: np.ndarray) -> "torch.Tensor":
    """``a`` as a contiguous tensor whose data start one float into its storage."""
    buf = torch.empty(a.size + 1, dtype=torch.float32)
    buf[1:] = torch.from_numpy(np.ascontiguousarray(a).reshape(-1))
    t = buf[1:].view(a.shape)
    assert t.is_contiguous() and t.storage_offset() == 1
    return t


def _scans_bit_equal(arrs, tensors):
    """The port's dense scans on ``tensors`` (both forms, CPU wrapper and plain
    versions) equal the reference's oracle and its Pallas kernels in
    interpret mode on ``arrs`` → the verdict."""
    q, q0, emb, emb0 = arrs
    tq, tq0, te, te0 = tensors
    Q, N = q.shape[0], emb.shape[0]
    want = np.asarray(jax_batch_ref(q, q0, emb, emb0, eps=1e-6)).astype(bool)
    pallas = np.asarray(jax_scan(q, q0, emb, emb0, eps=1e-6, block_n=128, interpret=True))
    np.testing.assert_array_equal(pallas.astype(bool), want)
    before = (ops.SINGLE_LAUNCHES, ops.BATCH_LAUNCHES)
    np.testing.assert_array_equal(ops.dominance_scan(tq, tq0, te, te0).numpy(), want)
    np.testing.assert_array_equal(dominance_scan_batch_ref(tq, tq0, te, te0).numpy(), want)
    for k in range(min(Q, 3)):
        pallas = np.asarray(jax_scan(q[k], q0[k], emb, emb0, block_n=128, interpret=True))
        np.testing.assert_array_equal(pallas.astype(bool), want[k])
        qk, q0k = tq[k].contiguous(), tq0[k].contiguous()
        np.testing.assert_array_equal(ops.dominance_scan(qk, q0k, te, te0).numpy(), want[k])
        np.testing.assert_array_equal(dominance_scan_ref(qk, q0k, te, te0).numpy(), want[k])
    assert (ops.SINGLE_LAUNCHES, ops.BATCH_LAUNCHES) == before, "CPU tensors launch nothing"
    assert want.shape == (Q, N)
    return want


@pytest.mark.parametrize("Q,N,D,D0", [(1, 37, 18, 6), (7, 1037, 18, 6), (5, 300, 5, 3)])
def test_dense_scans_all_labels_match(Q, N, D, D0):
    """``make_scan(match_labels=True)``: every row carries its partner query's
    labels, so every row passes the label test for some query and the
    dominance columns (ties, ulps, +inf rows) decide."""
    arrs = make_scan(Q, N, seed=3 * N + Q, D=D, D0=D0, match_labels=True)
    q, q0, emb, emb0 = arrs
    assert np.isfinite(q0).all() and np.isfinite(emb0).all()
    labels_only = np.asarray(jax_batch_ref(np.full_like(q, -np.inf), q0, emb, emb0)).astype(bool)
    assert labels_only.any(axis=0).all()
    want = _scans_bit_equal(arrs, _torch(arrs))
    assert 0 < want.sum() < want.size


@pytest.mark.parametrize("Q,N,D,D0", [(1, 300, 18, 6), (7, 1037, 18, 6), (3, 129, 5, 3)])
def test_dense_scans_offset_base(Q, N, D, D0):
    """Operands whose data start one float into their storage (4 bytes past a
    16-byte boundary, as the card's word-copy path takes them)."""
    arrs = make_scan(Q, N, seed=5 * N + Q, D=D, D0=D0)
    want = _scans_bit_equal(arrs, [_at_offset(a) for a in arrs])
    assert want.any()
