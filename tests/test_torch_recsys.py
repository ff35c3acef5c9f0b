"""The DCN-v2 serving path of the port against the JAX package, at the smoke
width: embedding bags (single-hot bit-equal, multi-hot within 1e-6),
``make_batch`` arrays identical, and the ``serve`` and ``retrieval`` steps
built through ``repro_torch.configs`` equal to the JAX package's from the
same params (carried across by ``convert.dcn_params_from_reference``) and
the same batch: logits within rtol 1e-4 / atol 1e-5 (GEMM summation
order), retrieval values within 1e-5 and the same indices."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro.models import recsys as jrec  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.convert import dcn_params_from_reference  # noqa: E402
from repro_torch.models import recsys as trec  # noqa: E402
from repro_torch.models.common import dense_init  # noqa: E402

SERVE_CELLS = ["serve_p99", "serve_bulk", "retrieval_cand"]


def _setup(cell_name, smoke=True):
    jarch, tarch = jcfg.get_arch("dcn-v2"), tcfg.get_arch("dcn-v2")
    jcell, tcell = jarch.cell(cell_name), tarch.cell(cell_name)
    jc = jcfg.resolve_config(jarch, jcell, smoke=smoke)
    tc = tcfg.resolve_config(tarch, tcell, smoke=smoke)
    return (jarch, jcell, jc), (tarch, tcell, tc)


def _carried_params(seed=0):
    (jarch, _, jc), _ = _setup("serve_p99")
    jparams = jcfg.init_params(jarch, jc, jax.random.PRNGKey(seed))
    return jparams, dcn_params_from_reference(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.mark.parametrize("cell_name,smoke", [(c, True) for c in SERVE_CELLS]
                         + [("serve_p99", False), ("serve_bulk", False)])
def test_make_batch_arrays_identical(cell_name, smoke):
    (jarch, jcell, jc), (tarch, tcell, tc) = _setup(cell_name, smoke)
    want = jcfg.make_batch(jarch, jcell, jc, seed=5, smoke=smoke)
    got = tcfg.make_batch(tarch, tcell, tc, seed=5, smoke=smoke, device="cpu")
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == getattr(torch, str(want[k].dtype))
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    specs = jcfg.input_specs(jarch, jcell, jc, smoke=smoke)
    for k, (shape, dtype) in tcfg.input_specs(tarch, tcell, tc, smoke=smoke).items():
        assert shape == specs[k].shape and np.dtype(dtype) == specs[k].dtype


@pytest.mark.parametrize("multi", [False, True])
def test_embedding_bag_matches_reference(multi):
    rng = np.random.default_rng(7)
    F, V, E, B, nnz = 26, 256, 8, 9, 4
    tables = rng.normal(size=(F, V, E)).astype(np.float32) * 0.02
    if not multi:
        ids = rng.integers(0, V, (B, F)).astype(np.int32)
        want = np.asarray(jrec.embedding_bag(jnp.asarray(tables), jnp.asarray(ids)))
        got = trec.embedding_bag(torch.from_numpy(tables), torch.from_numpy(ids))
        np.testing.assert_array_equal(got.numpy(), want)  # single-hot: a row copy
        return
    ids = rng.integers(0, V, (B, F, nnz)).astype(np.int32)
    mask = rng.random((B, F, nnz)) < 0.6
    for m in (mask, None):
        want = np.asarray(jrec.embedding_bag(
            jnp.asarray(tables), jnp.asarray(ids), None if m is None else jnp.asarray(m)))
        got = trec.embedding_bag(torch.from_numpy(tables), torch.from_numpy(ids),
                                 None if m is None else torch.from_numpy(m))
        assert got.shape == (B, F, E)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cell_name,seed", [("serve_p99", 0), ("serve_bulk", 1), ("serve_p99", 2)])
def test_serve_step_logits_match_reference(cell_name, seed):
    (jarch, jcell, jc), (tarch, tcell, tc) = _setup(cell_name)
    jparams, tparams = _carried_params(seed)
    jstep, jopt = jcfg.build_step(jarch, jcell, jc)
    tstep, topt = tcfg.build_step(tarch, tcell, tc)
    assert jopt is topt is False
    want = np.asarray(jstep(jparams, jcfg.make_batch(jarch, jcell, jc, seed=seed)))
    got = tstep(tparams, tcfg.make_batch(tarch, tcell, tc, seed=seed, device="cpu"))
    assert got.shape == want.shape == (8,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_forward_with_retrieval_embedding_and_multi_hot_matches_reference():
    (_, _, jc), (_, _, tc) = _setup("serve_p99")
    jparams, tparams = _carried_params(3)
    rng = np.random.default_rng(3)
    dense = rng.normal(size=(6, jc.n_dense)).astype(np.float32)
    ids = rng.integers(0, jc.vocab_per_field, (6, jc.n_sparse, 3)).astype(np.int32)
    mask = rng.random((6, jc.n_sparse, 3)) < 0.7
    jl, ju = jrec.dcn_forward(jparams, jnp.asarray(dense), jnp.asarray(ids), jc,
                              sparse_mask=jnp.asarray(mask), return_emb=True)
    tl, tu = trec.dcn_forward(tparams, torch.from_numpy(dense), torch.from_numpy(ids), tc,
                              sparse_mask=torch.from_numpy(mask), return_emb=True)
    assert tu.shape == (6, tc.retrieval_dim)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 4])
def test_retrieval_step_matches_reference(seed):
    (jarch, jcell, jc), (tarch, tcell, tc) = _setup("retrieval_cand")
    jparams, tparams = _carried_params(seed)
    jvals, jidx = jcfg.build_step(jarch, jcell, jc)[0](
        jparams, jcfg.make_batch(jarch, jcell, jc, seed=seed))
    tvals, tidx = tcfg.build_step(tarch, tcell, tc)[0](
        tparams, tcfg.make_batch(tarch, tcell, tc, seed=seed, device="cpu"))
    jvals, jidx = np.asarray(jvals), np.asarray(jidx)
    assert tvals.shape == tidx.shape == jvals.shape == (1, 100)
    np.testing.assert_allclose(tvals.numpy(), jvals, rtol=1e-5, atol=1e-5)
    # indices agree wherever the value is not tied with a neighbour within 1e-5
    gap = np.abs(np.diff(jvals[0]))
    distinct = np.ones(100, bool)
    distinct[:-1] &= gap > 1e-5
    distinct[1:] &= gap > 1e-5
    assert distinct.sum() > 50
    np.testing.assert_array_equal(tidx.numpy()[0][distinct], jidx[0][distinct])


def test_init_params_shapes_and_seeding():
    (jarch, _, jc), (tarch, _, tc) = _setup("serve_p99")
    jp = jax.tree.map(np.shape, jcfg.init_params(jarch, jc, jax.random.PRNGKey(0)))
    tp = tcfg.init_params(tarch, tc, seed=0, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), tp) == jp
    again = tcfg.init_params(tarch, tc, seed=0, device="cpu")
    other = tcfg.init_params(tarch, tc, seed=1, device="cpu")
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for t in jax.tree.leaves(tp, is_leaf=torch.is_tensor))
    assert torch.equal(again["tables"], tp["tables"])
    assert not torch.equal(other["tables"], tp["tables"])
    assert torch.count_nonzero(tp["cross"][0]["b"]) == 0
    assert tp["tables"].abs().max() <= 2 * 0.02


def test_init_params_goes_to_the_card_unless_told():
    (_, _, _), (tarch, _, tc) = _setup("serve_p99")
    if torch.cuda.is_available():
        assert tcfg.init_params(tarch, tc)["tables"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcfg.init_params(tarch, tc)


def test_dense_init_is_a_truncated_fan_in_normal():
    g = torch.Generator().manual_seed(0)
    w = dense_init(g, (400, 300))
    assert w.dtype == torch.float32 and w.shape == (400, 300)
    assert w.abs().max() <= 2 / np.sqrt(400)
    # a standard normal cut to [-2, 2] has std 0.8796
    assert abs(float(w.std()) * np.sqrt(400) - 0.8796) < 0.01
    v = dense_init(g, (64,), scale=0.5)
    assert v.abs().max() <= 1.0


def test_unported_kinds_and_archs_raise():
    arch = tcfg.get_arch("dcn-v2")
    cell = arch.cell("train_batch")
    cfg = tcfg.resolve_config(arch, cell, smoke=True)
    # the train kind is ported now (ROADMAP item 17a): no recsys kind raises
    _, takes_opt = tcfg.build_step(arch, cell, cfg)
    assert takes_opt
    assert sorted(tcfg.make_batch(arch, cell, cfg, device="cpu")) == ["dense", "label", "sparse"]
    # every architecture of the reference resolves now, the GNN zoo and GNN-PE's cells too
    for name in ("schnet", "gin-tu", "gnn-pe-online"):
        ta, ja = tcfg.get_arch(name), jcfg.get_arch(name)
        assert (ta.name, ta.family, ta.source) == (ja.name, ja.family, ja.source)
        assert [c.name for c in ta.shapes] == [c.name for c in ja.shapes]
        cfg = tcfg.resolve_config(ta, ta.shapes[0], smoke=True)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jcfg.resolve_config(ja, ja.shapes[0], smoke=True))
    with pytest.raises(KeyError):
        tcfg.get_arch("no-such-arch")
