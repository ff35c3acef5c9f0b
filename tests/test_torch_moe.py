"""The port's MoE block (``repro_torch.models.moe``) against the JAX
package's ``models/moe.py`` on one device (its ``mesh=None`` branch), on
the CPU in float32, params carried across from the reference's.

Routing is discrete, so it is held exactly: the top-k expert ids, and the
kept and dropped (token, expert) sets (recomputed here with NumPy from the
reference's ids by its stable-sort rule), are identical.  Outputs within
rtol 1e-5 / atol 1e-6 and the aux loss within 1e-6 relative: the same
float32 algorithm, products summed in another order.  Gradients within 1e-4
of each leaf's largest entry."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro_torch.models import cast_params  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.train import tree_leaves, value_and_grad  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-6)


def _carried(mcfg, D: int, seed: int):
    jp = jmoe.init_moe_params(jax.random.PRNGKey(seed), D, mcfg)
    return jp, {k: torch.from_numpy(np.array(v, np.float32)) for k, v in jp.items()}


def _tokens(T: int, D: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(T, D)).astype(np.float32)


def _kept_by_reference_rule(topi: np.ndarray, mcfg) -> tuple:
    """The reference's capacity rule on its own expert ids, in NumPy: entries
    sorted by expert (stable), rank = index − the expert's first index."""
    T, K = topi.shape
    cap = max(int(T * K / mcfg.n_experts * mcfg.capacity_factor), 4)
    flat_e, flat_t = topi.reshape(-1), np.repeat(np.arange(T), K)
    order = np.argsort(flat_e, kind="stable")
    se, st = flat_e[order], flat_t[order]
    rank = np.arange(se.size) - np.searchsorted(se, se, side="left")
    pairs = list(zip(st.tolist(), se.tolist()))
    return ({p for p, r in zip(pairs, rank) if r < cap},
            {p for p, r in zip(pairs, rank) if r >= cap}, cap)


@pytest.mark.parametrize("n_shared", [0, 2])
@pytest.mark.parametrize("T,E,cf", [(96, 8, 1.0), (8, 4, 0.25), (40, 8, 0.5)])
def test_moe_block_equals_the_reference_with_capacity_drops(n_shared, T, E, cf):
    """T = 96 over 8 experts at capacity factor 1.0 (cap 24); T = 8 over 4 at
    0.25, a decode step held up by the capacity's floor of 4; T = 40 over 8 at
    0.5 (cap 5): experts overflow and drop in each."""
    D = 32
    mcfg = tmoe.MoEConfig(n_experts=E, top_k=2, d_ff_expert=48, n_shared=n_shared,
                          capacity_factor=cf)
    jcfg = jmoe.MoEConfig(n_experts=E, top_k=2, d_ff_expert=48, n_shared=n_shared,
                          capacity_factor=cf)
    jp, tp = _carried(jcfg, D, seed=T + n_shared)
    x = _tokens(T, D, seed=T)
    jtopi, jtopv, jaux = jmoe._route(jnp.asarray(x), jp["router"], jcfg)
    ttopi, ttopv, taux = tmoe._route(torch.from_numpy(x), tp["router"], mcfg)
    np.testing.assert_array_equal(ttopi.numpy(), np.asarray(jtopi))
    np.testing.assert_allclose(ttopv.numpy(), np.asarray(jtopv), **F32)
    kept, dropped, cap = _kept_by_reference_rule(np.asarray(jtopi), jcfg)
    plan = tmoe.dispatch_plan(ttopi, ttopv, mcfg)
    pairs = list(zip(plan["token"].tolist(), plan["expert"].tolist()))
    got_kept = {p for p, k in zip(pairs, plan["keep"].tolist()) if k}
    got_dropped = {p for p, k in zip(pairs, plan["keep"].tolist()) if not k}
    assert plan["cap"] == cap and got_kept == kept and got_dropped == dropped
    assert dropped, "the case must drop entries past the capacity"
    want, want_aux = jmoe.moe_block(jnp.asarray(x), jp, jcfg)
    got, aux = tmoe.moe_block(torch.from_numpy(x), tp, mcfg)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_dropped_entries_leave_the_output_and_kept_ones_count_once():
    """With capacity 4 and every token routed to the same two experts, only
    the first 4 tokens (stable order) get the routed part; the rest get the
    shared experts' output alone."""
    D = 16
    mcfg = tmoe.MoEConfig(n_experts=4, top_k=2, d_ff_expert=8, n_shared=1, capacity_factor=0.5)
    g = torch.Generator().manual_seed(0)
    p = tmoe.init_moe_params(g, D, mcfg)
    p["router"] = torch.zeros((D, 4))
    p["router"][0, :2] = 10.0  # every token with a positive x[:, 0] picks experts 0 and 1
    x = torch.randn((12, D), generator=g)
    x[:, 0] = x[:, 0].abs() + 1.0
    plan = tmoe.dispatch_plan(*tmoe._route(x, p["router"], mcfg)[:2], mcfg)
    assert plan["cap"] == 4
    assert sorted(set(plan["token"][plan["keep"]].tolist())) == [0, 1, 2, 3]
    out, _ = tmoe.moe_block(x, p, mcfg)
    a = x @ p["shared_w1"]
    shared = (a * torch.sigmoid(a) * (x @ p["shared_w3"])) @ p["shared_w2"]
    torch.testing.assert_close(out[4:], shared[4:])
    assert not torch.allclose(out[:4], shared[:4])


def test_moe_gradients_equal_jax_grad():
    D, T = 24, 48
    jcfg = jmoe.MoEConfig(n_experts=8, top_k=2, d_ff_expert=16, n_shared=1, capacity_factor=1.0)
    mcfg = tmoe.MoEConfig(n_experts=8, top_k=2, d_ff_expert=16, n_shared=1, capacity_factor=1.0)
    jp, tp = _carried(jcfg, D, seed=3)
    x = _tokens(T, D, seed=4)

    def jloss(p):
        out, aux = jmoe.moe_block(jnp.asarray(x), p, jcfg)
        return jnp.sum(out**2) + 0.01 * aux

    want = jax.grad(jloss)(jp)

    def tloss(p, b):
        out, aux = tmoe.moe_block(b, p, mcfg)
        return torch.sum(out**2) + 0.01 * aux, {}

    (_, _), got = value_and_grad(tloss, tp, torch.from_numpy(x))
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        lim = 1e-4 * np.abs(w).max()
        assert np.abs(got[k].numpy() - w).max() <= lim, k


def test_router_stays_float32():
    """The reference creates the router in float32 whatever the dtype and
    routes in float32: ``init_moe_params`` and ``cast_params`` keep it so."""
    mcfg = tmoe.MoEConfig(n_experts=4, top_k=2, d_ff_expert=8, n_shared=1)
    g = torch.Generator().manual_seed(1)
    p = tmoe.init_moe_params(g, 16, mcfg, dtype=torch.bfloat16)
    assert p["router"].dtype == torch.float32
    assert {k for k, t in p.items() if t.dtype == torch.bfloat16} == set(p) - {"router"}
    ref = tmoe.init_moe_params(torch.Generator().manual_seed(1), 16, mcfg)
    for k in p:  # the same draws, cast as each is drawn
        assert torch.equal(p[k], ref[k].to(p[k].dtype)), k
    tree = cast_params({"layers": [{"moe": ref}]}, torch.bfloat16)
    assert tree["layers"][0]["moe"]["router"].dtype == torch.float32
    assert all(t.dtype == torch.bfloat16 for k, t in tree["layers"][0]["moe"].items()
               if k != "router")
    x = torch.randn((5, 16), generator=g).to(torch.bfloat16)
    out, aux = tmoe.moe_block(x, tree["layers"][0]["moe"], mcfg)
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert len(tree_leaves(tree)) == 7
