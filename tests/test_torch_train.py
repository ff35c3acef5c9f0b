"""The port's training path (``repro_torch.train``, the ``train`` kinds of
``repro_torch.configs``) on the CPU, held against the JAX package at the
smoke width, from params carried by ``convert``.

- ``dcn_loss`` and ``lm_loss`` (chunked and not, ``remat`` on and off): the
  loss within 1e-6 relative and every parameter's gradient within 1e-5 of
  its largest entry, against ``jax.value_and_grad`` of the reference's;
- one ``build_step`` train step of each arch, ``grad_accum`` 1 and 2: the
  metrics within 1e-5 relative, ``m`` and ``v`` within 1e-5 of their
  largest entry, the new params within 0.02·lr of the reference's (AdamW's
  first step moves a param by about lr, so this is 2 % of a step);
- each kernel's ``autograd.Function`` against autograd of its plain forward
  (K5 also by float64 ``gradcheck``), and a detached output caught;
- ``convert`` carrying an AdamW state and a ``Trainer`` checkpoint across,
  and a port ``Trainer`` resuming from the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.configs as rc  # noqa: E402
from repro.models import dcn_loss as ref_dcn_loss  # noqa: E402
from repro.models import lm_loss as ref_lm_loss  # noqa: E402
from repro.train.trainer import Trainer as RefTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as RefTrainerConfig  # noqa: E402
from repro.train.optimizer import OptConfig as RefOptConfig  # noqa: E402
import repro_torch.configs as tc  # noqa: E402
from repro_torch.configs.base import train_wrap  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    dcn_params_from_reference,
    lm_params_from_reference,
    opt_state_from_reference,
    trainer_state_from_reference,
)
from repro_torch.kernels.cross_interact import ops as ci  # noqa: E402
from repro_torch.kernels.cross_interact.ref import make_cross  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_plain, make_attn  # noqa: E402
from repro_torch.kernels.star_agg import ops as sa  # noqa: E402
from repro_torch.kernels.star_agg.ref import make_bags, star_agg_ref  # noqa: E402
from repro_torch.models import dcn_loss, lm_loss  # noqa: E402
from repro_torch.train import OptConfig, Trainer, TrainerConfig, tree_leaves  # noqa: E402
from repro_torch.train import value_and_grad  # noqa: E402

ARCHS = {
    "dcn-v2": ("train_batch", dcn_params_from_reference),
    "gemma3-1b": ("train_4k", lm_params_from_reference),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: test files run in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def setup(arch_name: str, **cfg_fields):
    """(reference arch, cell, cfg, params, batch), (port arch, cell, cfg,
    params carried over, batch): the same smoke config in both packages."""
    import dataclasses

    cell_name, conv = ARCHS[arch_name]
    ra = rc.get_arch(arch_name)
    rcell = ra.cell(cell_name)
    rcfg = dataclasses.replace(rc.resolve_config(ra, rcell, smoke=True), **cfg_fields)
    rp = rc.init_params(ra, rcfg, jax.random.PRNGKey(0))
    rb = rc.make_batch(ra, rcell, rcfg, seed=0, smoke=True)
    pa = tc.get_arch(arch_name)
    pcell = pa.cell(cell_name)
    pcfg = dataclasses.replace(tc.resolve_config(pa, pcell, smoke=True), **cfg_fields)
    pb = tc.make_batch(pa, pcell, pcfg, seed=0, device="cpu")
    for k, want in rb.items():
        np.testing.assert_array_equal(pb[k].numpy(), np.asarray(want), err_msg=k)
    return (ra, rcell, rcfg, rp, rb), (pa, pcell, pcfg, conv(rp, device="cpu"), pb)


def assert_trees_close(got, want, rel: float, what: str, atol: float = 0.0):
    """Every leaf of ``got`` within ``rel`` of ``want``'s largest entry (plus
    ``atol``); the trees' structures equal."""
    g, w = tree_leaves(got), tree_leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.shape == b.shape and a.dtype == b.dtype, f"{what} leaf {i}"
        lim = rel * float(b.abs().max()) + atol
        err = float((a - b).abs().max()) if a.numel() else 0.0
        assert err <= lim, f"{what} leaf {i}: |err| {err} > {lim}"


def ref_loss_fn(arch_name, cfg):
    if arch_name == "dcn-v2":
        return lambda p, b: ref_dcn_loss(p, b, cfg)
    return lambda p, b: ref_lm_loss(p, b, cfg)


def port_loss_fn(arch_name, cfg):
    if arch_name == "dcn-v2":
        return lambda p, b: dcn_loss(p, b, cfg)
    return lambda p, b: lm_loss(p, b, cfg)


@pytest.mark.parametrize("arch_name,fields", [
    ("dcn-v2", {}),
    ("gemma3-1b", {}),
    ("gemma3-1b", {"loss_chunk": 96}),  # 512 = 5 chunks of 96 and one of 32
    ("gemma3-1b", {"remat": True, "loss_chunk": 128}),
])
def test_loss_and_gradients_equal_the_reference(arch_name, fields):
    (_, _, rcfg, rp, rb), (_, _, pcfg, pp, pb) = setup(arch_name, **fields)
    conv = ARCHS[arch_name][1]
    (rl, rm), rg = jax.value_and_grad(ref_loss_fn(arch_name, rcfg), has_aux=True)(rp, rb)
    (pl, pm), pg = value_and_grad(port_loss_fn(arch_name, pcfg), pp, pb)
    assert float(pl) == pytest.approx(float(rl), rel=1e-6)
    assert float(pm["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-6)
    assert_trees_close(pg, conv(rg, device="cpu"), 1e-5, "gradients")


def test_remat_and_chunked_loss_leave_the_gradients_alone():
    """``remat`` recomputes each layer and ``loss_chunk`` each vocab chunk in
    the backward; neither changes the loss, and the gradients agree to the
    float32 rounding of a different summation order."""
    (_, _, _, _, _), (_, _, pcfg, pp, pb) = setup("gemma3-1b")
    import dataclasses

    (l0, _), g0 = value_and_grad(port_loss_fn("gemma3-1b", pcfg), pp, pb)
    for fields in ({"remat": True}, {"loss_chunk": 100}, {"remat": True, "loss_chunk": 256}):
        cfg = dataclasses.replace(pcfg, **fields)
        (l1, _), g1 = value_and_grad(port_loss_fn("gemma3-1b", cfg), pp, pb)
        assert float(l1) == pytest.approx(float(l0), rel=1e-6), fields
        if fields == {"remat": True}:  # the same ops again: bit for bit
            assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g1), tree_leaves(g0)))
        else:
            assert_trees_close(g1, g0, 1e-5, f"gradients {fields}")


@pytest.mark.parametrize("arch_name", list(ARCHS))
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_equals_the_reference(arch_name, grad_accum):
    fields = {"grad_accum": grad_accum} if arch_name == "gemma3-1b" else {}
    (ra, rcell, rcfg, rp, rb), (pa, pcell, pcfg, pp, pb) = setup(arch_name, **fields)
    conv = ARCHS[arch_name][1]
    rstep, r_opt = rc.build_step(ra, rcell, rcfg)
    pstep, p_opt = tc.build_step(pa, pcell, pcfg)
    assert r_opt and p_opt
    if arch_name == "dcn-v2" and grad_accum == 2:
        # the recsys step takes no grad_accum in either package: hold the
        # port's microbatched train_wrap to the reference's on its loss
        rstep = _ref_accum_step(rcfg, 2)
        pstep = train_wrap(lambda p, b: dcn_loss(p, b, pcfg), OptConfig(), 2)
    ropt, popt = rc.opt_init(rp), tc.opt_init(pp)
    for _ in range(2):  # two steps: the second sees non-zero moments
        rp, ropt, rmet = rstep(rp, ropt, rb)
        pp, popt, pmet = pstep(pp, popt, pb)
    assert sorted(pmet) == sorted(rmet)
    for k in rmet:
        assert float(pmet[k]) == pytest.approx(float(rmet[k]), rel=1e-5, abs=1e-9), k
    assert int(popt["step"]) == int(ropt["step"]) == 2 and popt["step"].dtype == torch.int32
    assert_trees_close(popt["m"], conv(ropt["m"], device="cpu"), 1e-5, "m")
    assert_trees_close(popt["v"], conv(ropt["v"], device="cpu"), 1e-5, "v")
    lr = float(rmet["lr"])
    assert_trees_close(pp, conv(rp, device="cpu"), 1e-6, "params", atol=0.02 * lr)


def _ref_accum_step(cfg, accum):
    """The reference's ``train_wrap`` with ``grad_accum`` on the DCN-v2 loss."""
    import jax.numpy as jnp

    from repro.train.optimizer import adamw_update

    loss_fn = ref_loss_fn("dcn-v2", cfg)

    def step(params, opt_state, batch):
        micro = jax.tree.map(
            lambda x: x.reshape((accum, x.shape[0] // accum) + x.shape[1:]), batch)
        grads = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
        loss_sum = jnp.zeros((), jnp.float32)
        for i in range(accum):
            mb = jax.tree.map(lambda x: x[i], micro)
            (loss, _), g = jax.value_and_grad(loss_fn, has_aux=True)(params, mb)
            grads = jax.tree.map(lambda a, b: a + b.astype(jnp.float32), grads, g)
            loss_sum = loss_sum + loss
        grads = jax.tree.map(lambda g: g / accum, grads)
        new_params, new_opt, om = adamw_update(grads, opt_state, params, RefOptConfig())
        return new_params, new_opt, {"loss": loss_sum / accum, **om}

    return step


# ------------------------------------------------------ kernel backwards ---


def test_star_agg_backward_equals_autograd_of_the_plain_forward():
    idx, mask, table = make_bags(40, 3, 17, 5, seed=1)
    idx_t, mask_t = torch.from_numpy(idx), torch.from_numpy(mask)
    g = torch.from_numpy(np.random.default_rng(2).normal(size=(40, 5)).astype(np.float32))
    t1 = torch.from_numpy(table).requires_grad_(True)
    (sa.star_agg(idx_t, mask_t, t1) * g).sum().backward()
    t2 = torch.from_numpy(table).requires_grad_(True)
    (star_agg_ref(idx_t, mask_t, t2) * g).sum().backward()
    np.testing.assert_allclose(t1.grad.numpy(), t2.grad.numpy(), rtol=1e-6, atol=1e-6)
    assert t1.grad.shape == (17, 5) and t1.grad[~np.isin(np.arange(17), idx[mask])].abs().sum() == 0


def test_cross_interact_backward_equals_autograd_and_gradcheck():
    x0, x, w, b = (torch.from_numpy(a) for a in make_cross(16, 12, seed=3))
    g = torch.from_numpy(np.random.default_rng(4).normal(size=(16, 12)).astype(np.float32))
    ins1 = [t.clone().requires_grad_(True) for t in (x0, x, w, b)]
    (ci.cross_interact(*ins1) * g).sum().backward()
    ins2 = [t.clone().requires_grad_(True) for t in (x0, x, w, b)]
    (ci.cross_interact_ref(*ins2) * g).sum().backward()
    for a, c in zip(ins1, ins2):
        np.testing.assert_allclose(a.grad.numpy(), c.grad.numpy(), rtol=1e-5, atol=1e-5)
    # float64 through the Function itself: the plain forward takes it
    ins64 = [t.double().requires_grad_(True) for t in (x0[:4, :5], x[:4, :5], w[:5, :5], b[:5])]
    assert torch.autograd.gradcheck(ci._CrossInteract.apply, ins64)


@pytest.mark.parametrize("window", [None, 5])
def test_flash_attention_backward_equals_autograd_of_the_plain_forward(window):
    q, k, v = (torch.from_numpy(a) for a in make_attn(2, 24, 4, 1, 16, seed=5))
    g = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 24, 4, 16)).astype(np.float32))
    ins1 = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (fa.flash_attention(*ins1, window=window, chunk=8) * g).sum().backward()
    ins2 = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (flash_attention_plain(*ins2, True, window, 8) * g).sum().backward()
    for a, c in zip(ins1, ins2):
        np.testing.assert_allclose(a.grad.numpy(), c.grad.numpy(), rtol=1e-5, atol=1e-6)
        assert float(a.grad.abs().max()) > 0


def test_a_detached_kernel_output_loses_the_gradients(monkeypatch):
    """The fault phase 12a plants on the card: a K5 wrapper whose output has
    no ``grad_fn`` leaves the tables, W and b without gradients, and the
    comparison against autograd of the plain forward catches it."""
    (_, _, _, _, _), (_, _, pcfg, pp, pb) = setup("dcn-v2")
    (_, _), good = value_and_grad(port_loss_fn("dcn-v2", pcfg), pp, pb)
    plain = ci.cross_interact_ref
    monkeypatch.setattr(ci, "cross_interact", lambda *a: plain(*a).detach())
    (_, _), bad = value_and_grad(port_loss_fn("dcn-v2", pcfg), pp, pb)
    assert float(bad["tables"].abs().max()) == 0 < float(good["tables"].abs().max())
    assert all(float(c["w"].abs().max()) == 0 for c in bad["cross"])
    with pytest.raises(AssertionError):
        assert_trees_close(bad, good, 1e-5, "gradients")


# --------------------------------------------------------------- convert ---


def test_opt_state_and_trainer_checkpoint_carry_across(tmp_path):
    """A reference ``Trainer`` checkpoint of the smoke LM: ``convert`` gives
    the port's tree (params, AdamW state, step), and the port's step from
    it equals the reference's next step."""
    (ra, rcell, rcfg, rp, rb), (pa, pcell, pcfg, pp, pb) = setup("gemma3-1b")
    opt = RefOptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    data = lambda s: rb  # noqa: E731
    rtr = RefTrainer(ref_loss_fn("gemma3-1b", rcfg), rp, data,
                     RefTrainerConfig(total_steps=2, ckpt_every=2, ckpt_dir=str(tmp_path),
                                      async_checkpoint=False, opt=opt), jit=False)
    rtr.run()
    state = trainer_state_from_reference(tmp_path, family="lm", device="cpu")
    assert int(state["step"]) == 2 and int(state["opt"]["step"]) == 2
    assert_trees_close(state["params"], lm_params_from_reference(rtr.params, device="cpu"), 0,
                       "params")
    carried = opt_state_from_reference(rtr.opt_state, lm_params_from_reference, device="cpu")
    assert_trees_close(state["opt"]["m"], carried["m"], 0, "m")
    ptr = Trainer(port_loss_fn("gemma3-1b", pcfg), pp, lambda s: pb,
                  TrainerConfig(total_steps=1, ckpt_every=100, ckpt_dir=str(tmp_path / "port"),
                                opt=OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)))
    ptr.load_state(state)
    ptr.run(1)
    rtr.run(1)
    assert ptr.history[-1]["loss"] == pytest.approx(rtr.history[-1]["loss"], rel=1e-5)
    assert_trees_close(ptr.params, lm_params_from_reference(rtr.params, device="cpu"), 1e-6,
                       "params", atol=0.02 * 1e-3)


def test_port_trainer_resumes_a_reference_checkpoint(tmp_path):
    """Same keys, same tree: the port's ``try_resume`` reads the reference
    ``Trainer``'s directory and carries on as the reference would."""
    import jax.numpy as jnp

    def ref_loss(params, batch):
        return jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2), {}

    def port_loss(params, batch):
        return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2), {}

    def batch(step):
        rng = np.random.default_rng(step)
        x = rng.normal(size=(32, 4)).astype(np.float32)
        return {"x": x, "y": x @ np.array([1.0, -2.0, 3.0, 0.5], np.float32)}

    opt = dict(lr=0.05, warmup_steps=0, total_steps=40, weight_decay=0.0)
    cfg = dict(total_steps=40, ckpt_every=20, ckpt_dir=str(tmp_path), async_checkpoint=False)
    whole = RefTrainer(ref_loss, {"w": jnp.zeros((4,))}, batch,
                       RefTrainerConfig(**{**cfg, "ckpt_dir": str(tmp_path / "whole")},
                                        opt=RefOptConfig(**opt)))
    whole.run(40)
    RefTrainer(ref_loss, {"w": jnp.zeros((4,))}, batch,
               RefTrainerConfig(**cfg, opt=RefOptConfig(**opt))).run(20)
    ptr = Trainer(port_loss, {"w": torch.zeros(4)}, batch, TrainerConfig(**cfg, opt=OptConfig(**opt)))
    assert ptr.try_resume() and ptr.step == 20
    ptr.run(20)
    np.testing.assert_allclose(ptr.params["w"].numpy(), np.asarray(whole.params["w"]), rtol=1e-5)
