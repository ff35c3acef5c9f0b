"""The rest of the LM family in the port against the JAX package, on the CPU
at each smoke width in float32: minitron-4b and command-r-plus-104b (full
attention, an untied head), deepseek-v2-lite-16b (MLA with its absorbed
decode, a dense first layer, MoE with shared experts) and
qwen3-moe-235b-a22b (GQA with MoE), with params carried across by
``convert.lm_params_from_reference`` and batches from both packages'
``make_batch`` (identical arrays).

Tolerances: float32 logits and cache rows within rtol 1e-4 / atol 1e-5 (the
same float32 algorithm, GEMMs and softmax sums in another order); the MoE
aux loss within 1e-5 relative (routing is discrete and must agree);
``DecodeEngine`` token lists identical; the loss within 1e-6 relative and
each gradient leaf within 1e-5 of its largest entry; train steps as
``test_torch_train.py`` holds gemma3-1b's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serve.engine import DecodeEngine as JaxEngine  # noqa: E402
from repro.serve.engine import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.models import MoEConfig, cast_params  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serve import DecodeEngine, ServeConfig  # noqa: E402
from repro_torch.train import tree_leaves, value_and_grad  # noqa: E402

ARCHS = ["minitron-4b", "command-r-plus-104b", "deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"]
FULL_ATTN = ["minitron-4b", "command-r-plus-104b", "qwen3-moe-235b-a22b"]
F32 = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: test files run in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(name, cell_name="prefill_32k", **fields):
    ja, ta = jcfg.get_arch(name), tcfg.get_arch(name)
    jcell, tcell = ja.cell(cell_name), ta.cell(cell_name)
    jc = dataclasses.replace(jcfg.resolve_config(ja, jcell, smoke=True), **fields)
    tc = dataclasses.replace(tcfg.resolve_config(ta, tcell, smoke=True), **fields)
    return (ja, jcell, jc), (ta, tcell, tc)


def _carried(name, seed=0, **fields):
    (ja, _, jc), _ = _setup(name, **fields)
    jp = jcfg.init_params(ja, jc, jax.random.PRNGKey(seed))
    return jp, lm_params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


@pytest.mark.parametrize("name", ARCHS)
def test_carried_params_keep_the_reference_layout(name):
    """``prefix_layers`` then the stacked ``layers`` become one list of layer
    dicts (a MoE layer's ``moe`` dict nested); ``init_params`` draws the same
    shapes, the router float32, the rest in the compute dtype."""
    (ja, _, jc), (ta, _, tc) = _setup(name)
    jp, tp = _carried(name)
    layers = list(jp.get("prefix_layers", [])) + [
        jax.tree.map(lambda a, i=i: a[i], jp["layers"]) for i in range(jc.n_layers - jc.first_dense)]
    assert len(tp["layers"]) == tc.n_layers == len(layers)
    for got, want in zip(tp["layers"], layers):
        assert _shapes(got) == jax.tree.map(lambda a: tuple(a.shape), want)
    assert ("lm_head" in tp) == (not tc.tie_embeddings) == ("lm_head" in jp)
    drawn = tcfg.init_params(ta, dataclasses.replace(tc, dtype="bfloat16"), seed=0, device="cpu")
    assert _shapes(drawn) == _shapes(tp)
    for i, p in enumerate(drawn["layers"]):
        assert ("moe" in p) == tc.is_moe(i)
        if "moe" in p:
            assert p["moe"]["router"].dtype == torch.float32
    assert {t.dtype for t in tree_leaves(drawn)} <= {torch.bfloat16, torch.float32}
    assert sum(t.dtype == torch.float32 for t in tree_leaves(drawn)) == sum(
        tc.is_moe(i) for i in range(tc.n_layers))


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_logits_and_aux_match_jax(name, seed):
    (ja, jcell, jc), (ta, tcell, tc) = _setup(name)
    jp, tp = _carried(name, seed)
    jb = jcfg.make_batch(ja, jcell, jc, seed=seed)
    tb = tcfg.make_batch(ta, tcell, tc, seed=seed, device="cpu")
    np.testing.assert_array_equal(tb["tokens"].numpy(), jb["tokens"])
    want = np.asarray(jcfg.build_step(ja, jcell, jc)[0](jp, jb))
    before = fa.LAUNCHES
    got = tcfg.build_step(ta, tcell, tc)[0](tp, tb)
    assert fa.LAUNCHES == before and got.shape == want.shape == (2, 64, tc.vocab)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    want_logits, want_aux = jtr.lm_forward(jp, jnp.asarray(jb["tokens"]), jc)
    logits, aux = ttr.lm_forward(tp, tb["tokens"], tc)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **F32)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)
    assert (float(aux) > 0) == (tc.moe is not None)


@pytest.mark.parametrize("name", ARCHS)
def test_make_batch_decode_cache_identical(name):
    (ja, jcell, jc), (ta, tcell, tc) = _setup(name, "decode_32k")
    want = jcfg.make_batch(ja, jcell, jc, seed=5)
    got = tcfg.make_batch(ta, tcell, tc, seed=5, device="cpu")
    assert list(got) == list(want) and list(got["cache"]) == list(want["cache"])
    assert list(got["cache"]) == (["ckv", "krope"] if tc.use_mla else ["k", "v"])
    for k in want["cache"]:
        np.testing.assert_array_equal(got["cache"][k].numpy(), want["cache"][k])
    np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])
    assert int(got["cur_len"]) == int(want["cur_len"])
    assert {k: s[0] for k, s in tcfg.input_specs(ta, tcell, tc, smoke=True)["cache"].items()} \
        == {k: tuple(v.shape) for k, v in want["cache"].items()}
    assert {k: tuple(v.shape) for k, v in ttr.init_cache(tc, 2, 64, device="cpu").items()} \
        == {k: tuple(v.shape) for k, v in want["cache"].items()}


@pytest.mark.parametrize("name", ARCHS)
def test_decode_steps_match_jax_past_the_cache_end(name):
    """Steps at cur_len 5, 40, 63 (the last row) and 64, 90 past the end,
    where the write clamps to the last row: logits and the whole cache."""
    (ja, jcell, jc), (ta, tcell, tc) = _setup(name, "decode_32k")
    jp, tp = _carried(name, 3)
    jb = jcfg.make_batch(ja, jcell, jc, seed=7)
    tb = tcfg.make_batch(ta, tcell, tc, seed=7, device="cpu")
    jstep = jcfg.build_step(ja, jcell, jc)[0]
    tstep = tcfg.build_step(ta, tcell, tc)[0]
    rng = np.random.default_rng(7)
    for cur in (5, 40, 63, 64, 90):
        tokens = rng.integers(0, tc.vocab, (2,)).astype(np.int32)
        jb = dict(jb, tokens=tokens, cur_len=np.asarray(cur, np.int32))
        want_logits, want_cache = jstep(jp, jb)
        logits, cache = tstep(tp, dict(tb, tokens=torch.from_numpy(tokens),
                                       cur_len=torch.tensor(cur, dtype=torch.int32)))
        assert cache is tb["cache"]  # updated in place
        np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **F32)
        for k in cache:
            np.testing.assert_allclose(cache[k].numpy(), np.asarray(want_cache[k]), **F32)
        jb["cache"] = want_cache  # the next step continues from the written caches


def test_mla_decode_continues_a_prefill():
    """Teacher-forced absorbed decode steps over the latent cache give the
    prefill's logits (capacity high enough that no token drops in either)."""
    _, (_, _, tc) = _setup("deepseek-v2-lite-16b")
    tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, capacity_factor=16.0))
    _, tp = _carried("deepseek-v2-lite-16b", 4)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, tc.vocab, (2, 20)))
    want, _ = ttr.lm_forward(tp, tokens, tc)
    cache = ttr.init_cache(tc, 2, 32, device="cpu")
    for t in range(20):
        logits, cache = ttr.decode_step(tp, cache, tokens[:, t], t, tc)
        np.testing.assert_allclose(logits.numpy(), want[:, t].numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_engine_tokens_identical_to_jax(name):
    """5 requests through 3 slots: slots reused, one shared cur_len."""
    (_, _, jc), (_, _, tc) = _setup(name)
    jp, tp = _carried(name, 5)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, tc.vocab, rng.integers(1, 9)).tolist() for _ in range(5)]
    jeng = JaxEngine(jp, jc, JaxServeConfig(max_batch=3, max_len=48, eos_token=-1))
    teng = DecodeEngine(tp, tc, ServeConfig(max_batch=3, max_len=48, eos_token=-1), device="cpu")
    for p in prompts:
        assert jeng.submit(p, max_new=6) == teng.submit(p, max_new=6)
    got, want = teng.run_until_drained(), jeng.run_until_drained()
    assert got == want and set(got) == set(range(5))
    assert teng.cur_len == jeng.cur_len
    assert sorted(teng.cache) == sorted(jeng.cache)


@pytest.mark.parametrize("name,fields", [(n, {}) for n in ARCHS] + [
    ("command-r-plus-104b", {"loss_chunk": 96}),
    ("deepseek-v2-lite-16b", {"remat": True}),
])
def test_lm_loss_and_gradients_match_jax(name, fields):
    (ja, jcell, jc), (ta, tcell, tc) = _setup(name, "train_4k", **fields)
    jp, tp = _carried(name, 6, **fields)
    jb = jcfg.make_batch(ja, jcell, jc, seed=6)
    tb = tcfg.make_batch(ta, tcell, tc, seed=6, device="cpu")
    (jl, jm), jg = jax.value_and_grad(lambda p, b: jtr.lm_loss(p, b, jc), has_aux=True)(jp, jb)
    (tl, tm), tg = value_and_grad(lambda p, b: ttr.lm_loss(p, b, tc), tp, tb)
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-6)
    assert float(tm["aux"]) == pytest.approx(float(jm["aux"]), rel=1e-5)
    want = tree_leaves(lm_params_from_reference(jax.tree.map(np.asarray, jg), device="cpu"))
    got = tree_leaves(tg)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max()), i


@pytest.mark.parametrize("name", ARCHS)
def test_train_step_matches_jax(name):
    """``build_step``'s train kind: two AdamW steps from the carried params."""
    (ja, jcell, jc), (ta, tcell, tc) = _setup(name, "train_4k")
    jp, tp = _carried(name, 7)
    jb = jcfg.make_batch(ja, jcell, jc, seed=7)
    tb = tcfg.make_batch(ta, tcell, tc, seed=7, device="cpu")
    jstep, jopt = jcfg.build_step(ja, jcell, jc)
    tstep, topt = tcfg.build_step(ta, tcell, tc)
    assert jopt and topt
    jo, to = jcfg.opt_init(jp), tcfg.opt_init(tp)
    for _ in range(2):
        jp, jo, jmet = jstep(jp, jo, jb)
        tp, to, tmet = tstep(tp, to, tb)
    for k in ("loss", "lr", "grad_norm"):
        assert float(tmet[k]) == pytest.approx(float(jmet[k]), rel=1e-5), k
    lr = float(jmet["lr"])
    want = tree_leaves(lm_params_from_reference(jax.tree.map(np.asarray, jp), device="cpu"))
    for i, (g, w) in enumerate(zip(tree_leaves(tp), want)):
        assert float((g - w).abs().max()) <= 1e-6 * float(w.abs().max()) + 0.02 * lr, i


def test_bf16_params_keep_the_router_float32_and_are_checked():
    """Serving casts once (``cast_params``), the router staying float32; the
    steps refuse uncast params and take the router as it is."""
    (ja, jcell, jc), (ta, tcell, tc) = _setup("qwen3-moe-235b-a22b", dtype="bfloat16")
    jp, tp = _carried("qwen3-moe-235b-a22b", 8)
    step = tcfg.build_step(ta, tcell, tc)[0]
    batch = tcfg.make_batch(ta, tcell, tc, seed=8, device="cpu")
    bf = cast_params(tp, torch.bfloat16)
    assert all(p["moe"]["router"].dtype == torch.float32 for p in bf["layers"])
    got = step(bf, batch)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    want = np.asarray(jcfg.build_step(ja, jcell, jc)[0](jp, jcfg.make_batch(ja, jcell, jc, seed=8)),
                      np.float32)
    # the reference's logits within 2e-2 of magnitudes up to 0.6 (bf16 at every op; a
    # near-tied gate may route a token elsewhere, so held on the shared rows' median)
    assert float(np.median(np.abs(got.float().numpy() - want))) < 2e-2
    with pytest.raises(ValueError, match="cast_params"):
        step(tp, batch)


@pytest.mark.parametrize("name", ARCHS + ["gemma3-1b"])
def test_n_params_equal_the_reference_at_published_size(name):
    (ja, _, _), (ta, _, _) = _setup(name)
    jc = jcfg.resolve_config(ja, ja.cell("prefill_32k"), smoke=False)
    tc = tcfg.resolve_config(ta, ta.cell("prefill_32k"), smoke=False)
    assert tc.n_params() == jc.n_params() and tc.n_active_params() == jc.n_active_params()
    assert tc.name == jc.name == name
    assert [tc.is_global(i) for i in range(tc.n_layers)] == [
        i < jc.first_dense or jc.attention == "full" or (i + 1) % jc.global_period == 0
        for i in range(jc.n_layers)]


def test_registry_resolves_the_lm_family_and_names_what_is_left():
    for name in ARCHS + ["gemma3-1b", "dcn-v2"]:
        assert tcfg.get_arch(name).name == name
        assert tcfg.get_arch(name).source == jcfg.get_arch(name).source
    # nothing is left: the GNN zoo and GNN-PE's own cells resolve to the reference's fields
    for name in ("schnet", "gin-tu", "gnn-pe-online"):
        ta, ja = tcfg.get_arch(name), jcfg.get_arch(name)
        assert (ta.name, ta.family, ta.source, ta.notes) == (ja.name, ja.family, ja.source, ja.notes)
        assert [(c.name, c.kind, c.meta, c.skip) for c in ta.shapes] == [
            (c.name, c.kind, c.meta, c.skip) for c in ja.shapes]
        tc = tcfg.resolve_config(ta, ta.shapes[0], smoke=True)
        jc = jcfg.resolve_config(ja, ja.shapes[0], smoke=True)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)


@pytest.mark.parametrize("name", ARCHS + ["gemma3-1b"])
def test_long_500k_skipped_as_in_the_reference(name):
    ta, ja = tcfg.get_arch(name), jcfg.get_arch(name)
    assert [(c.name, c.kind, c.meta, c.skip) for c in ta.shapes] == [
        (c.name, c.kind, c.meta, c.skip) for c in ja.shapes]
    assert (ta.cell("long_500k").skip is not None) == (name in FULL_ATTN)


@pytest.mark.parametrize("dh,dv,G", [(24, 16, 1), (192, 128, 1), (40, 16, 2)])
def test_flash_attention_takes_a_narrower_v(dh, dv, G):
    """K6's wrapper on the CPU with dv < dqk (MLA's shape at the smoke and the
    published width): the plain path against the reference's
    ``chunked_attention`` (scale 1/√dqk), and its gradient against jax.grad."""
    from repro.models.transformer import chunked_attention as jax_chunked

    rng = np.random.default_rng(dh)
    B, S, Hkv = 2, 37, 2
    q = rng.normal(size=(B, S, Hkv * G, dh)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, dh)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, dv)).astype(np.float32)
    gout = rng.normal(size=(B, S, Hkv * G, dv)).astype(np.float32)
    pos = jnp.arange(S, dtype=jnp.int32)

    def jfn(q, k, v):
        return jax_chunked(q.reshape(B, S, Hkv, G, dh), k, v, pos, pos, None, 16)

    want = jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jg = jax.grad(lambda *a: jnp.sum(jfn(*a) * gout), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    got = fa.flash_attention(tq, tk, tv, chunk=16)
    assert got.shape == (B, S, Hkv * G, dv)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)
    torch.sum(got * torch.from_numpy(gout)).backward()
    for t, w in zip((tq, tk, tv), jg):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="shapes"):
        fa.flash_attention(tq, tk, torch.zeros((B, S, Hkv, dh + 16)))
