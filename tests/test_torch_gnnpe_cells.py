"""GNN-PE's own cells in the port against the JAX package, at the smoke
configs: ``gnn-pe-offline`` (one train step of the stacked partition GAT
encoders on Eq. 7's hinge) and ``gnn-pe-online`` (the leaf scan's candidate
counts) with the reference's params carried across.

Batches identical; the offline loss within 1e-5·(1 + |ref|), its gradients
(recovered from AdamW's first moment) within 1e-4·(1 + max|ref|) a leaf,
the params after the step within 1e-6·(1 + max|ref|); the online counts
exactly equal in all four ``quantize_int8`` × ``label_hash`` settings, with
planted rows so that the counts are not all zero, also when the scan takes
its rows in chunks that do not divide the index."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.configs.base import online_counts  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    gnnpe_offline_params_from_reference,
    gnnpe_online_params_from_reference,
    opt_state_from_reference,
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(name, **fields):
    ja, ta = jcfg.get_arch(name), tcfg.get_arch(name)
    jc = dataclasses.replace(jcfg.resolve_config(ja, ja.shapes[0], smoke=True), **fields)
    tc = dataclasses.replace(tcfg.resolve_config(ta, ta.shapes[0], smoke=True), **fields)
    return (ja, ja.shapes[0], jc), (ta, ta.shapes[0], tc)


def _same_batch(jb, tb):
    assert list(jb) == list(tb)
    for k in jb:
        a = np.asarray(jb[k])
        assert a.dtype == tb[k].numpy().dtype and np.array_equal(a, tb[k].numpy()), k


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    lim = rel * (1.0 + float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= lim, what


def test_offline_step_matches_the_reference():
    (ja, jcell, jc), (ta, tcell, tc) = _setup("gnn-pe-offline")
    jb = jcfg.make_batch(ja, jcell, jc, seed=4)
    tb = tcfg.make_batch(ta, tcell, tc, seed=4, device="cpu")
    _same_batch(jb, tb)
    jp = jax.jit(lambda k: jcfg.init_params(ja, jc, k))(jax.random.PRNGKey(2))  # vmapped init
    jo = jcfg.opt_init(jp)
    jn, jo2, jm = jax.jit(jcfg.build_step(ja, jcell, jc)[0])(jp, jo, jb)
    tp = gnnpe_offline_params_from_reference(jp, device="cpu")
    assert all(v.shape[0] == tc.m for v in tp.values())
    step, takes_opt = tcfg.build_step(ta, tcell, tc)
    tn, to2, tm = step(tp, opt_state_from_reference(jo, gnnpe_offline_params_from_reference,
                                                    device="cpu"), tb)
    assert takes_opt
    _close(tm["loss"].item(), float(jm["loss"]), 1e-5, "loss")
    _close(tm["grad_norm"].item(), float(jm["grad_norm"]), 1e-5, "grad norm")
    scale = min(1.0, 1.0 / max(float(jm["grad_norm"]), 1e-9))
    for k in jp:
        _close(to2["m"][k].numpy() / (0.1 * scale), np.asarray(jo2["m"][k]) / (0.1 * scale),
               1e-4, f"gradient {k}")
        _close(tn[k].numpy(), np.asarray(jn[k]), 1e-6, f"param {k}")


@pytest.mark.parametrize("quantize_int8", [False, True])
@pytest.mark.parametrize("label_hash", [False, True])
def test_online_counts_equal_the_reference_exactly(quantize_int8, label_hash):
    (ja, jcell, jc), (ta, tcell, tc) = _setup(
        "gnn-pe-online", quantize_int8=quantize_int8, label_hash=label_hash)
    jb = jcfg.make_batch(ja, jcell, jc, seed=6)
    tb = tcfg.make_batch(ta, tcell, tc, seed=6, device="cpu")
    _same_batch(jb, tb)
    jp = {k: np.array(v) for k, v in jcfg.init_params(ja, jc, jax.random.PRNGKey(3)).items()}
    q, q0 = np.asarray(jb["q"]), np.asarray(jb["q0"])
    for i in range(q.shape[0]):  # i + 1 rows that query i must match
        for r in range(i + 1):
            jp["emb"][97 * i + 13 * r + 5] = q[i]
            jp["emb0"][97 * i + 13 * r + 5] = q0[i]
    want = np.asarray(jax.jit(jcfg.build_step(ja, jcell, jc)[0])(jp, jb))
    tp = gnnpe_online_params_from_reference(jp, device="cpu")
    step, takes_opt = tcfg.build_step(ta, tcell, tc)
    got = step(tp, tb)
    assert not takes_opt and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert (want >= np.arange(1, q.shape[0] + 1)).all()
    assert np.array_equal(online_counts(tp, tb, tc, rows=1000).numpy(), want)


def test_online_params_are_the_packed_index():
    _, (ta, _, tc) = _setup("gnn-pe-online", quantize_int8=True, label_hash=True)
    p = tcfg.init_params(ta, tc, seed=0, device="cpu")
    assert p["emb"].dtype == torch.int8 and p["emb"].shape == (tc.n_paths, tc.d_cat)
    assert p["emb0"].dtype == torch.int32 and p["emb0"].shape == (tc.n_paths,)
    assert int(p["emb"].min()) >= 0 and int(p["emb"].max()) < 127
