"""The GNN zoo in the port against the JAX package, on the CPU at the smoke
sizes: gin, sage, schnet and mace over the full graph, ELL blocks and
molecules, with params carried across by ``convert.gnn_params_from_reference``
and batches from both packages' ``make_batch`` (identical arrays).

Tolerances: outputs and losses within 1e-5·(1 + max|ref|); gradients within
1e-4·(1 + max|ref|) a leaf; params after one AdamW step within
1e-6·(1 + max|ref|).  The port sums each node's messages in another order
(edges sorted by destination, chunked), so float32 rounding differs; mace's
cubic invariants (values up to ~3e4 on the molecule cell) are the largest
case and still fit."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.convert import gnn_params_from_reference, opt_state_from_reference  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.train import tree_leaves  # noqa: E402

ARCHS = ["gin-tu", "graphsage-reddit", "schnet", "mace"]
CELLS = ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]
KINDS = ["gin", "sage", "schnet", "mace"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: test files run in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    lim = rel * (1.0 + float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= lim, f"{what}: |err| {err:.3g} > {lim:.3g}"


def _setup(name, cell_name):
    ja, ta = jcfg.get_arch(name), tcfg.get_arch(name)
    jcell, tcell = ja.cell(cell_name), ta.cell(cell_name)
    return (ja, jcell, jcfg.resolve_config(ja, jcell, smoke=True)), (
        ta, tcell, tcfg.resolve_config(ta, tcell, smoke=True))


def _graph(seed=0, N=40, E=160, d_in=12):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, d_in)).astype(np.float32),
            rng.integers(0, N, (E, 2)).astype(np.int32),
            rng.normal(size=(N, 3)).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


_j_full = jax.jit(jgnn.gnn_forward_full, static_argnums=(1,))
_j_blocks = jax.jit(jgnn.gnn_forward_blocks, static_argnums=(1,))
_j_energy = jax.jit(jgnn.gnn_energy_loss, static_argnums=(1,))


def _pair(kind, **fields):
    kw = dict(kind=kind, n_layers=2, d_hidden=16, d_in=12, n_classes=4, n_rbf=8, **fields)
    jc, tc = jgnn.GNNConfig(**kw), tgnn.GNNConfig(**kw)
    jp = jgnn.init_gnn_params(jax.random.PRNGKey(7), jc)
    return jc, tc, jp, gnn_params_from_reference(jp, device="cpu")


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("cell_name", CELLS)
def test_make_batch_arrays_identical(name, cell_name):
    (ja, jcell, jc), (ta, tcell, tc) = _setup(name, cell_name)
    want = jax.tree.leaves(jcfg.make_batch(ja, jcell, jc, seed=5))
    got = tree_leaves(tcfg.make_batch(ta, tcell, tc, seed=5, device="cpu"))
    assert len(got) == len(want)
    for a, b in zip(want, got):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype and np.array_equal(a, b.numpy())


def test_make_batch_partition_parallel_layout_identical(monkeypatch):
    monkeypatch.setenv("REPRO_OVERRIDES", "partition_parallel=true,n_shards=4")
    (ja, jcell, jc), (ta, tcell, tc) = _setup("gin-tu", "ogb_products")
    assert tc.partition_parallel and tc.n_shards == 4
    want = jcfg.make_batch(ja, jcell, jc, seed=2)
    got = tcfg.make_batch(ta, tcell, tc, seed=2, device="cpu")
    assert list(got) == list(want)
    for k in want:
        assert np.array_equal(np.asarray(want[k]), got[k].numpy()), k


@pytest.mark.parametrize("kind", KINDS)
def test_forward_full_blocks_and_energy_loss(kind):
    jc, tc, jp, tp = _pair(kind)
    x, ei, pos = _graph(1)
    want = np.asarray(_j_full(jp, jc, x, ei, pos))
    got = tgnn.gnn_forward_full(tp, tc, _t(x), _t(ei), _t(pos))
    _close(got.numpy(), want, 1e-5, f"{kind} full")
    # ELL blocks: 3 layers of vertex sets (24 → 8 → 3 rows), outermost first
    rng = np.random.default_rng(2)
    blocks = []
    for n_dst, n_src, f in ((8, 24, 3), (3, 8, 2)):
        blocks.append({"nbr_index": rng.integers(0, n_src, (n_dst, f)).astype(np.int32),
                       "mask": rng.random((n_dst, f)) < 0.7,
                       "dst_index": rng.integers(0, n_src, (n_dst,)).astype(np.int32)})
    feats = rng.normal(size=(24, 12)).astype(np.float32)
    want = np.asarray(_j_blocks(jp, jc, feats, blocks))
    got = tgnn.gnn_forward_blocks(tp, tc, _t(feats), [{k: _t(v) for k, v in b.items()}
                                                      for b in blocks])
    _close(got.numpy(), want, 1e-5, f"{kind} blocks")
    # molecules: 4 graphs of 10 atoms as one disjoint graph
    B, M = 4, 10
    per = rng.integers(0, M, (B, 24, 2)) + (np.arange(B) * M)[:, None, None]
    batch = {"node_feat": rng.normal(size=(B * M, 12)).astype(np.float32),
             "edge_index": per.reshape(-1, 2).astype(np.int32),
             "positions": rng.normal(size=(B * M, 3)).astype(np.float32),
             "graph_id": np.repeat(np.arange(B, dtype=np.int32), M),
             "node_mask": (rng.random(B * M) < 0.9).astype(np.float32),
             "energy": rng.normal(size=(B,)).astype(np.float32)}
    wl, wm = _j_energy(jp, jc, batch)
    gl, gm = tgnn.gnn_energy_loss(tp, tc, {k: _t(v) for k, v in batch.items()})
    _close(gl.item(), float(wl), 1e-5, f"{kind} energy loss")
    _close(gm["energy_mae"].item(), float(wm["energy_mae"]), 1e-5, f"{kind} energy mae")


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("cell_name", CELLS)
def test_train_step_matches_the_reference(name, cell_name):
    """One ``build_step`` train step from the same params and AdamW state as
    the reference's jitted step: the loss, the gradients (recovered from the
    first moment, m = (1 − b1)·g·clip scale, and the gradient norm) and the
    new params.  schnet and mace in the sampled regime leave their layer
    params unused: zero gradients on both sides."""
    (ja, jcell, jc), (ta, tcell, tc) = _setup(name, cell_name)
    jb = jcfg.make_batch(ja, jcell, jc, seed=3)
    tb = tcfg.make_batch(ta, tcell, tc, seed=3, device="cpu")
    jp = jcfg.init_params(ja, jc, jax.random.PRNGKey(1))
    jo = jcfg.opt_init(jp)
    jn, jo2, jm = jax.jit(jcfg.build_step(ja, jcell, jc)[0])(jp, jo, jb)
    tp = gnn_params_from_reference(jp, device="cpu")
    to = opt_state_from_reference(jo, gnn_params_from_reference, device="cpu")
    step, takes_opt = tcfg.build_step(ta, tcell, tc)
    tn, to2, tm = step(tp, to, tb)
    assert takes_opt and int(to2["step"]) == 1
    _close(tm["loss"].item(), float(jm["loss"]), 1e-5, "loss")
    _close(tm["grad_norm"].item(), float(jm["grad_norm"]), 1e-5, "grad norm")

    def grads(m, gn):
        scale = min(1.0, 1.0 / max(float(gn), 1e-9))
        return [np.asarray(x, np.float64) / (0.1 * scale) for x in m]

    gw = grads(jax.tree.leaves(jo2["m"]), jm["grad_norm"])
    gg = grads([x.numpy() for x in tree_leaves(to2["m"])], tm["grad_norm"])
    assert len(gw) == len(gg)
    for i, (a, b) in enumerate(zip(gg, gw)):
        _close(a, b, 1e-4, f"gradient leaf {i}")
        if not b.any():
            assert not a.any(), f"gradient leaf {i} should be zero"
    for i, (a, b) in enumerate(zip(tree_leaves(tn), jax.tree.leaves(jn))):
        _close(a.numpy(), np.asarray(b), 1e-6, f"param leaf {i}")


@pytest.mark.parametrize("name", ARCHS)
def test_published_param_shapes_equal_the_reference(name):
    """Every cell's published config (d_in, n_classes from the cell): the
    port's params tree has the reference's shapes, leaf for leaf, and its
    count (the reference's by ``jax.eval_shape``, no allocation)."""
    ja, ta = jcfg.get_arch(name), tcfg.get_arch(name)
    for jcell, tcell in zip(ja.shapes, ta.shapes):
        jc = jcfg.resolve_config(ja, jcell, smoke=False)
        tc = tcfg.resolve_config(ta, tcell, smoke=False)
        want = jax.eval_shape(lambda: jcfg.init_params(ja, jc, jax.random.PRNGKey(0)))
        got = tcfg.init_params(ta, tc, seed=0, device="cpu")
        ws = [tuple(x.shape) for x in jax.tree.leaves(want)]
        gs = [tuple(x.shape) for x in tree_leaves(got)]
        assert gs == ws, tcell.name
        assert sum(int(np.prod(s)) for s in gs) == sum(int(np.prod(s)) for s in ws)


def _plain_segment_sum(h, src, dst, n):
    return h.new_zeros((n, h.shape[1])).index_add(0, dst, h[src])


@pytest.mark.parametrize("chunk", [1, 7, 60, 1000])
def test_segment_sum_chunks_against_the_plain_sum(chunk):
    """The chunked aggregation (E = 60 edges: chunks of 1, a non-divisor, E,
    more than E) equals the plain one and passes gradcheck in float64."""
    rng = np.random.default_rng(chunk)
    h = torch.tensor(rng.normal(size=(9, 3)), dtype=torch.float64, requires_grad=True)
    src = torch.tensor(rng.integers(0, 9, 60))
    dst = torch.tensor(rng.integers(0, 5, 60))
    got = tgnn.segment_sum(h, src, dst, 5, chunk)
    torch.testing.assert_close(got, _plain_segment_sum(h, src, dst, 5), rtol=1e-12, atol=1e-12)
    g = torch.randn(5, 3, dtype=torch.float64)
    (want_g,) = torch.autograd.grad(_plain_segment_sum(h, src, dst, 5), h, g)
    (got_g,) = torch.autograd.grad(tgnn.segment_sum(h, src, dst, 5, chunk), h, g)
    torch.testing.assert_close(got_g, want_g, rtol=1e-12, atol=1e-12)
    assert torch.autograd.gradcheck(lambda x: tgnn.segment_sum(x, src, dst, 5, chunk), (h,))


@pytest.mark.parametrize("kind", ["schnet", "mace"])
@pytest.mark.parametrize("chunk", [1, 7, 160, 1000])
def test_row_checkpointed_layers_against_one_chunk(kind, chunk):
    """schnet and mace run each layer a checkpointed row range at a time: at
    edge budgets of 1, a non-divisor of E = 160, E and more the forward and
    the gradients (params and features) equal the one-range run, and the
    chunked forward passes gradcheck in float64."""
    _, tc, _, tp = _pair(kind)
    x, ei, pos = _graph(4)

    def run(params, feat, ch):
        return tgnn.gnn_forward_full(params, tc, feat, _t(ei), _t(pos), edge_chunk=ch)

    def f64(t):
        return t.double().requires_grad_(True)

    tc = dataclasses.replace(tc, dtype="float64")
    p64 = _map(tp, f64)
    feat = f64(_t(x))
    want = run(p64, feat, 10**9)
    got = run(p64, feat, chunk)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)
    g = torch.randn_like(want)
    leaves = tree_leaves(p64) + [feat]
    gw = torch.autograd.grad(want, leaves, g, allow_unused=True)
    gg = torch.autograd.grad(got, leaves, g, allow_unused=True)
    for a, b in zip(gg, gw):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)
    if chunk != 7:
        return
    xs, es, ps = _graph(5, N=5, E=12)  # gradcheck on a 5-node graph: 60 inputs
    small = f64(_t(xs))
    assert torch.autograd.gradcheck(
        lambda f: tgnn.gnn_forward_full(p64, tc, f, _t(es), _t(ps), edge_chunk=chunk), (small,))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _rotation(seed):
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


@pytest.mark.parametrize("kind", ["schnet", "mace"])
def test_outputs_invariant_under_rotation_and_translation(kind):
    """schnet's and mace's outputs do not move under a seeded rotation plus
    translation of the positions, in the port and in the JAX package (the
    reference's MACE notes claim it; this is that test).  Float32 moments
    rotate with rounding, so within 1e-4·(1 + max|out|)."""
    jc, tc, jp, tp = _pair(kind)
    x, ei, pos = _graph(6)
    moved = (pos @ _rotation(6).T + np.array([3.0, -1.5, 0.25])).astype(np.float32)
    base = tgnn.gnn_forward_full(tp, tc, _t(x), _t(ei), _t(pos)).numpy()
    turned = tgnn.gnn_forward_full(tp, tc, _t(x), _t(ei), _t(moved)).numpy()
    _close(turned, base, 1e-4, f"port {kind}")
    jbase = np.asarray(_j_full(jp, jc, x, ei, pos))
    jturned = np.asarray(_j_full(jp, jc, x, ei, moved))
    _close(jturned, jbase, 1e-4, f"reference {kind}")
    assert np.abs(base).max() > 0.1  # the check is not vacuous
