"""The port's public index API and exports, held against the JAX package on
the CPU.

  * ``repro_torch.core`` and ``repro_torch.models`` export every name that
    ``repro.core`` and ``repro.models`` export;
  * ``query_index_batch`` gives the reference's row arrays and stats dicts
    on the inputs of ``tests/test_batched_online.py``'s property sweep
    (plain and int8 + label-hash indexes) and of
    ``tests/test_grouped_index.py``'s (group sidecars; ``use_groups`` both
    ways), and its soundness cases (duplicate vectors, int8 grid edges);
  * ``leaf_scan_batch`` gives the reference's rows from the reference's
    descent (the same leaf blocks and survival mask);
  * ``count_params`` of a gemma3-1b smoke param tree carried across equals
    the reference's.

The indexes are built from the same NumPy inputs by each package's
``build_index``, which order rows alike (``test_torch_index.py``), so row
numbers compare directly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as RC  # noqa: E402
import repro.models as RM  # noqa: E402
from repro import configs as jcfg  # noqa: E402
from repro.core import grouping as RG  # noqa: E402
from repro.core import index as RI  # noqa: E402
from repro.models.common import count_params as ref_count_params  # noqa: E402
import repro_torch.core as PC  # noqa: E402
import repro_torch.models as PM  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.core import grouping as PG  # noqa: E402
from repro_torch.core import index as PI  # noqa: E402
from repro_torch.models import count_params  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _both(paths, emb, emb0, emb_multi=None, block_size=64, quantize=False, path_labels=None):
    """The reference's and the port's index of the same inputs."""
    ref = RI.build_index(paths, emb, emb0, emb_multi, block_size=block_size, quantize=quantize,
                         path_labels=path_labels)
    port = PI.build_index(_t(paths.astype(np.int64)), _t(emb), _t(emb0),
                          None if emb_multi is None else _t(emb_multi), block_size=block_size,
                          quantize=quantize,
                          path_labels=None if path_labels is None
                          else _t(path_labels.astype(np.int64)))
    return ref, port


def _random_index(seed: int, quantize: bool):
    """``test_grouped_index._random_index`` (``test_batched_online``'s index
    draws too): (reference index, port index, rng, emb, emb0, emb_multi,
    lab_ids)."""
    rng = np.random.default_rng(seed)
    P = int(rng.integers(200, 3000))
    D = int(rng.integers(2, 5)) * 2
    emb = rng.random((P, D)).astype(np.float32)
    lab_ids = rng.integers(0, 5, (P, D // 2)).astype(np.int32)
    lab_vocab = rng.random((5, 2)).astype(np.float32)
    emb0 = lab_vocab[lab_ids].reshape(P, D)
    emb_multi = rng.random((2, P, D)).astype(np.float32)
    paths = rng.integers(0, 100, (P, D // 2)).astype(np.int32)
    ref, port = _both(paths, emb, emb0, emb_multi, block_size=int(rng.choice([32, 64, 128])),
                      quantize=quantize, path_labels=lab_ids if quantize else None)
    return ref, port, rng, emb, emb0, emb_multi, lab_ids


def _queries(rng, emb, emb0, emb_multi, lab_ids, quantize: bool):
    """The two tests' query draws: (q_emb, q_emb0, q_multi, q_label_hash)."""
    Q = int(rng.integers(1, 24))
    js = rng.integers(0, emb.shape[0], Q)
    q_emb = (emb[js] * rng.uniform(0.7, 1.0, (Q, 1))).astype(np.float32)
    q_emb0 = emb0[js]
    q_multi = (emb_multi[:, js] * rng.uniform(0.7, 1.0, (1, Q, 1))).astype(np.float32)
    qh = RI.hash_labels(lab_ids[js]) if quantize else None
    return q_emb, q_emb0, q_multi, qh


def _random_case(seed: int, quantize: bool):
    """``test_batched_online._random_index_and_queries``: (reference index,
    port index, (q_emb, q_emb0, q_multi, q_label_hash))."""
    ref, port, rng, *inputs = _random_index(seed, quantize)
    return ref, port, _queries(rng, *inputs, quantize)


def _assert_rows_equal(got: list, want: list):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("package", ["core", "models"])
def test_the_port_exports_every_name_the_reference_does(package):
    ref, port = {"core": (RC, PC), "models": (RM, PM)}[package]
    assert set(ref.__all__) <= set(port.__all__), sorted(set(ref.__all__) - set(port.__all__))
    for name in port.__all__:
        assert getattr(port, name) is not None, name


@pytest.mark.parametrize("seed", range(12))
def test_query_index_batch_equals_reference(seed):
    """``test_batched_online.py``'s sweep: rows and stats dicts."""
    quantize = bool(seed % 2)
    ref, port, (q_emb, q_emb0, q_multi, qh) = _random_case(seed, quantize)
    want, want_stats = RI.query_index_batch(ref, q_emb, q_emb0, q_multi, q_label_hash=qh,
                                            use_pallas=False, return_stats=True)
    got, got_stats = PI.query_index_batch(port, q_emb, q_emb0, q_multi, q_label_hash=qh,
                                          return_stats=True)
    _assert_rows_equal(got, want)
    assert got_stats == want_stats
    assert all(r.dtype == torch.int64 for r in got)


@pytest.mark.parametrize("use_groups", [False, True])
@pytest.mark.parametrize("seed", range(10))
def test_query_index_batch_with_groups_equals_reference(seed, use_groups):
    """``test_grouped_index.py``'s sweep: group sidecars of the same size on
    both indexes, the probe with and without them."""
    quantize = bool(seed % 2)
    ref, port, rng, *inputs = _random_index(seed, quantize)
    gsz = int(rng.choice([4, 8, 16]))
    RG.attach_groups(ref, gsz)
    PG.attach_groups(port, gsz)
    q_emb, q_emb0, q_multi, qh = _queries(rng, *inputs, quantize)
    want, want_stats = RI.query_index_batch(ref, q_emb, q_emb0, q_multi, q_label_hash=qh,
                                            use_pallas=False, use_groups=use_groups,
                                            return_stats=True)
    got, got_stats = PI.query_index_batch(port, q_emb, q_emb0, q_multi, q_label_hash=qh,
                                          use_groups=use_groups, return_stats=True)
    _assert_rows_equal(got, want)
    assert got_stats == want_stats


def test_query_index_batch_soundness_cases_equal_reference():
    """``test_grouped_index.py``'s adversarial MBRs: duplicate vectors (every
    row at q == e, none above it) and int8 grid edges, grouped and not."""
    P, D = 1000, 6
    emb, emb0 = np.full((P, D), 0.5, np.float32), np.full((P, D), 0.25, np.float32)
    ref, port = _both(np.zeros((P, 3), np.int32), emb, emb0)
    RG.attach_groups(ref, 8)
    PG.attach_groups(port, 8)
    q, q0 = np.full((1, D), 0.5, np.float32), np.full((1, D), 0.25, np.float32)
    for qq, qq0, n in ((q, q0, P), (q + 0.01, q0, 0), (q, q0 + 0.01, 0)):
        for use_groups in (False, True):
            got = PI.query_index_batch(port, qq, qq0, use_groups=use_groups)
            _assert_rows_equal(got, RI.query_index_batch(ref, qq, qq0, use_pallas=False,
                                                         use_groups=use_groups))
            assert got[0].numel() == n
    rng = np.random.default_rng(0)
    P = 500
    emb = (rng.integers(0, 251, (P, D)) / 250.0).astype(np.float32)
    lab_ids = rng.integers(0, 3, (P, 3)).astype(np.int32)
    emb0 = rng.random((3, 2)).astype(np.float32)[lab_ids].reshape(P, 6)
    ref, port = _both(rng.integers(0, 50, (P, 3)).astype(np.int32), emb, emb0, quantize=True,
                      path_labels=lab_ids)
    RG.attach_groups(ref, 4)
    PG.attach_groups(port, 4)
    for j in [0, 17, 499]:
        qh = np.asarray([int(RI.hash_labels(lab_ids[j][None])[0])])
        for use_groups in (False, True):
            want = RI.query_index_batch(ref, emb[j][None], emb0[j][None], q_label_hash=qh,
                                        use_pallas=False, use_groups=use_groups)
            got = PI.query_index_batch(port, emb[j][None], emb0[j][None], q_label_hash=qh,
                                       use_groups=use_groups)
            _assert_rows_equal(got, want)
            assert got[0].numel() > 0


@pytest.mark.parametrize("seed", range(6))
def test_leaf_scan_batch_equals_reference(seed):
    """One fused verdict over the reference descent's leaf blocks and
    survival mask (the label-hash prefilter on odd seeds)."""
    quantize = bool(seed % 2)
    ref, port, (q_emb, q_emb0, q_multi, qh) = _random_case(seed, quantize)
    cand, alive = RI._descend_batch(ref, q_emb, q_emb0, q_multi, 1e-6)
    want = RI.leaf_scan_batch(ref, cand, alive, q_emb, q_emb0, q_multi, 1e-6, q_label_hash=qh,
                              use_pallas=False)
    got = PI.leaf_scan_batch(port, cand.astype(np.int64), alive, q_emb, q_emb0, q_multi, 1e-6,
                             q_label_hash=qh)
    _assert_rows_equal(got, want)
    # no surviving block: every query's rows empty, as the reference's
    none = PI.leaf_scan_batch(port, np.zeros((0,), np.int64), alive[:, :0], q_emb, q_emb0,
                              q_multi, 1e-6)
    assert [r.numel() for r in none] == [0] * q_emb.shape[0]


def test_query_index_batch_routes_as_the_engine():
    """``use_pallas`` as the engine's ``use_pallas_scan``: True forces K1,
    which needs a card; a CPU index takes the plain verdict."""
    ref, port, (q_emb, q_emb0, q_multi, _) = _random_case(0, False)
    with pytest.raises(ValueError, match="CUDA"):
        PI.query_index_batch(port, q_emb, q_emb0, q_multi, use_pallas=True)
    got = PI.query_index_batch(port, q_emb, q_emb0, q_multi, use_pallas=False)
    _assert_rows_equal(got, RI.query_index_batch(ref, q_emb, q_emb0, q_multi, use_pallas=False))


def test_count_params_equals_reference():
    arch = jcfg.get_arch("gemma3-1b")
    cfg = jcfg.resolve_config(arch, arch.cell("train_4k"), smoke=True)
    jparams = jcfg.init_params(arch, cfg, jax.random.PRNGKey(0))
    tparams = lm_params_from_reference(jax.tree.map(np.asarray, jparams), device="cpu")
    assert count_params(tparams) == ref_count_params(jparams) > 0
