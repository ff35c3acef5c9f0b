"""The gemma3-1b serving path of the port against the JAX package, on the CPU
at the smoke width (6 layers, window 16, float32), with params carried
across by ``convert.lm_params_from_reference`` and batches from both
packages' ``make_batch`` (identical arrays).

Tolerances: float32 logits and cache rows within rtol 1e-4 / atol 1e-5
(the same float32 algorithm; GEMM and softmax sums in another order);
RMSNorm and RoPE within 1e-6 in float32 and one bf16 ulp (2⁻⁷ relative)
in bf16; the bf16 variant of the model within 2e-2 absolute on logits of
magnitude up to 0.6 (two stacks rounding to bf16 at every op, in other
orders); ``DecodeEngine`` token lists identical."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serve.engine import DecodeEngine as JaxEngine  # noqa: E402
from repro.serve.engine import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serve import DecodeEngine, ServeConfig  # noqa: E402

LM_CELLS = ["prefill_32k", "decode_32k", "long_500k"]
F32 = dict(rtol=1e-4, atol=1e-5)


def _setup(cell_name="prefill_32k", dtype=None):
    jarch, tarch = jcfg.get_arch("gemma3-1b"), tcfg.get_arch("gemma3-1b")
    jcell, tcell = jarch.cell(cell_name), tarch.cell(cell_name)
    jc = jcfg.resolve_config(jarch, jcell, smoke=True)
    tc = tcfg.resolve_config(tarch, tcell, smoke=True)
    if dtype is not None:
        jc, tc = dataclasses.replace(jc, dtype=dtype), dataclasses.replace(tc, dtype=dtype)
    return (jarch, jcell, jc), (tarch, tcell, tc)


def _carried_params(seed=0):
    (jarch, _, jc), _ = _setup()
    jparams = jcfg.init_params(jarch, jc, jax.random.PRNGKey(seed))
    return jparams, lm_params_from_reference(jax.tree.map(np.asarray, jparams), device="cpu")


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope_match_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    gamma = (0.1 * rng.normal(size=16)).astype(np.float32)
    pos = np.arange(100, 109, dtype=np.int32)
    jx, tx = jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else dict(rtol=2**-7, atol=2**-7)
    want = jcommon.rms_norm(jx, jnp.asarray(gamma))
    got = tcommon.rms_norm(tx, torch.from_numpy(gamma))
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)
    want = jcommon.apply_rope(jx, jnp.asarray(pos)[None, :], 10000.0)
    got = tcommon.apply_rope(tx, torch.from_numpy(pos)[None, :], 10000.0)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)
    np.testing.assert_allclose(tcommon.rope_freqs(16).numpy(), np.asarray(jcommon.rope_freqs(16)),
                               rtol=1e-7)


@pytest.mark.parametrize("cell_name", LM_CELLS)
def test_make_batch_arrays_identical(cell_name):
    (jarch, jcell, jc), (tarch, tcell, tc) = _setup(cell_name)
    want = jcfg.make_batch(jarch, jcell, jc, seed=5)
    got = tcfg.make_batch(tarch, tcell, tc, seed=5, device="cpu")
    assert list(got) == list(want)
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, w), (_, g) in zip(flat_want, flat_got):
        assert g.dtype == getattr(torch, str(w.dtype)), path
        assert g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), w)
    specs = jcfg.input_specs(jarch, jcell, jc, smoke=True)
    tspecs = tcfg.input_specs(tarch, tcell, tc, smoke=True)
    assert jax.tree.map(lambda s: s.shape, specs) == jax.tree.map(
        lambda s: s[0], tspecs, is_leaf=lambda s: isinstance(s, tuple))


@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_logits_match_jax(seed):
    (jarch, jcell, jc), (tarch, tcell, tc) = _setup("prefill_32k")
    jparams, tparams = _carried_params(seed)
    jstep, jopt = jcfg.build_step(jarch, jcell, jc)
    tstep, topt = tcfg.build_step(tarch, tcell, tc)
    assert jopt is topt is False
    want = np.asarray(jstep(jparams, jcfg.make_batch(jarch, jcell, jc, seed=seed)))
    before = fa.LAUNCHES
    got = tstep(tparams, tcfg.make_batch(tarch, tcell, tc, seed=seed, device="cpu"))
    assert fa.LAUNCHES == before
    assert got.shape == want.shape == (2, 64, tc.vocab)
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_lm_forward_returns_zero_aux_and_matches_jax_past_the_window():
    """A sequence of 40 > window 16 with a local-layer chunk of 32: every
    layer's window binds, and the last chunk is padded."""
    (_, _, jc), (_, _, tc) = _setup()
    jparams, tparams = _carried_params(2)
    tokens = np.random.default_rng(2).integers(0, tc.vocab, (3, 40)).astype(np.int32)
    want, jaux = jtr.lm_forward(jparams, jnp.asarray(tokens), jc)
    got, aux = ttr.lm_forward(tparams, torch.from_numpy(tokens), tc)
    assert float(aux) == float(jaux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("cell_name,cur_len", [("decode_32k", None), ("decode_32k", 40),
                                               ("long_500k", None), ("long_500k", 63)])
def test_decode_step_logits_and_cache_match_jax(cell_name, cur_len):
    """At the cell's ``cur_len`` (5), past the window (40) and at the last row (63)."""
    (jarch, jcell, jc), (tarch, tcell, tc) = _setup(cell_name)
    jparams, tparams = _carried_params(3)
    jbatch = jcfg.make_batch(jarch, jcell, jc, seed=7)
    tbatch = tcfg.make_batch(tarch, tcell, tc, seed=7, device="cpu")
    if cur_len is not None:
        jbatch["cur_len"] = np.asarray(cur_len, np.int32)
        tbatch["cur_len"] = torch.tensor(cur_len, dtype=torch.int32)
    want_logits, want_cache = jcfg.build_step(jarch, jcell, jc)[0](jparams, jbatch)
    logits, cache = tcfg.build_step(tarch, tcell, tc)[0](tparams, tbatch)
    assert cache is tbatch["cache"]  # updated in place
    assert logits.shape == (2, tc.vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **F32)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(want_cache[name]), **F32)


@pytest.mark.parametrize("cur_len", [46, 47, 132])
def test_decode_step_past_the_cache_end_matches_jax(cur_len):
    """Smax 32, window 16: from cur_len 47 = Smax + window − 1 on, a local
    layer's window keeps no row.  The reference clamps the write to row 31,
    masks every row and averages all 32; at 46 the window keeps row 31 alone."""
    (_, _, jc), (_, _, tc) = _setup("decode_32k")
    jparams, tparams = _carried_params(9)
    rng = np.random.default_rng(cur_len)
    shape = (tc.n_layers, 2, 32, tc.n_kv_heads, tc.head_dim)
    cache = {n: rng.normal(size=shape).astype(np.float32) for n in ("k", "v")}
    tokens = rng.integers(0, tc.vocab, (2,)).astype(np.int32)
    want_logits, want_cache = jtr.decode_step(
        jparams, {n: jnp.asarray(c) for n, c in cache.items()}, jnp.asarray(tokens),
        jnp.asarray(cur_len, jnp.int32), jc)
    tcache = {n: torch.from_numpy(c.copy()) for n, c in cache.items()}
    logits, got_cache = ttr.decode_step(tparams, tcache, torch.from_numpy(tokens), cur_len, tc)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **F32)
    for name in ("k", "v"):
        np.testing.assert_allclose(got_cache[name].numpy(), np.asarray(want_cache[name]), **F32)


def test_decode_steps_continue_a_prefill():
    """Teacher-forced decode steps from an empty cache give the prefill's logits."""
    _, (_, _, tc) = _setup()
    _, tparams = _carried_params(4)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, tc.vocab, (2, 24)))
    want, _ = ttr.lm_forward(tparams, tokens, tc)
    cache = ttr.init_cache(tc, 2, 32, device="cpu")
    for t in range(24):
        logits, cache = ttr.decode_step(tparams, cache, tokens[:, t], t, tc)
        np.testing.assert_allclose(logits.numpy(), want[:, t].numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("max_batch,eos", [(3, -1), (2, 7)])
def test_decode_engine_tokens_identical_to_jax(max_batch, eos):
    """More requests than slots: slots are reused, share one cur_len, and the
    engines pick the same tokens."""
    (_, _, jc), (_, _, tc) = _setup()
    jparams, tparams = _carried_params(5)
    rng = np.random.default_rng(eos + 10)
    prompts = [rng.integers(0, tc.vocab, rng.integers(1, 9)).tolist() for _ in range(5)]
    jeng = JaxEngine(jparams, jc, JaxServeConfig(max_batch=max_batch, max_len=64, eos_token=eos))
    teng = DecodeEngine(tparams, tc, ServeConfig(max_batch=max_batch, max_len=64, eos_token=eos),
                        device="cpu")
    for p in prompts:
        assert jeng.submit(p, max_new=6) == teng.submit(p, max_new=6)
    want = jeng.run_until_drained()
    got = teng.run_until_drained()
    assert got == want
    assert teng.cur_len == jeng.cur_len
    assert set(got) == set(range(5))


def test_decode_engine_stops_at_max_len():
    (_, _, jc), (_, _, tc) = _setup()
    jparams, tparams = _carried_params(6)
    jeng = JaxEngine(jparams, jc, JaxServeConfig(max_batch=2, max_len=12, eos_token=-1))
    teng = DecodeEngine(tparams, tc, ServeConfig(max_batch=2, max_len=12, eos_token=-1),
                        device="cpu")
    for eng in (jeng, teng):
        for p in ([1, 2, 3], [4, 5], [6]):
            eng.submit(p, max_new=20)
    assert teng.run_until_drained() == jeng.run_until_drained() == {}
    assert teng.cur_len == jeng.cur_len == 11
    assert [s.tokens for s in teng.slots] == [s.tokens for s in jeng.slots]


def test_bf16_variant_matches_jax():
    """bf16 compute: the JAX package casts its float32 params at each use,
    the port takes them cast once (exact to those casts) and refuses
    float32 params."""
    (jarch, jcell, jc), (tarch, tcell, tc) = _setup("prefill_32k", dtype="bfloat16")
    jparams, tparams = _carried_params(8)
    want = jcfg.build_step(jarch, jcell, jc)[0](jparams, jcfg.make_batch(jarch, jcell, jc, seed=8))
    step = tcfg.build_step(tarch, tcell, tc)[0]
    batch = tcfg.make_batch(tarch, tcell, tc, seed=8, device="cpu")
    got = step(ttr.cast_params(tparams, torch.bfloat16), batch)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=2e-2)
    with pytest.raises(ValueError, match="cast_params"):
        step(tparams, batch)
    dcell = tarch.cell("decode_32k")
    with pytest.raises(ValueError, match="cast_params"):
        tcfg.build_step(tarch, dcell, tc)[0](
            tparams, tcfg.make_batch(tarch, dcell, tc, seed=8, device="cpu"))
    drawn = tcfg.init_params(tarch, tc, seed=0, device="cpu")
    assert {t.dtype for p in drawn["layers"] for t in p.values()} == {torch.bfloat16}


def test_init_cache_goes_to_the_card_unless_told():
    _, (_, _, tc) = _setup()
    if torch.cuda.is_available():
        assert ttr.init_cache(tc, 2, 8)["k"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttr.init_cache(tc, 2, 8)
    cache = ttr.init_cache(tc, 2, 8, device="cpu")
    assert cache["v"].shape == (tc.n_layers, 2, 8, tc.n_kv_heads, tc.head_dim)
    assert cache["k"].dtype == tc.compute_dtype and not cache["k"].any()


def test_init_params_shapes_and_seeding():
    (jarch, _, jc), (tarch, _, tc) = _setup()
    jp = jcfg.init_params(jarch, jc, jax.random.PRNGKey(0))
    tp = tcfg.init_params(tarch, tc, seed=0, device="cpu")
    assert tuple(tp["embed"].shape) == jp["embed"].shape
    assert tuple(tp["final_norm"].shape) == jp["final_norm"].shape
    assert len(tp["layers"]) == tc.n_layers
    for layer in tp["layers"]:
        assert {k: tuple(t.shape) for k, t in layer.items()} == {
            k: v.shape[1:] for k, v in jp["layers"].items()}
        assert all(t.dtype == torch.float32 for t in layer.values())
    again = tcfg.init_params(tarch, tc, seed=0, device="cpu")
    other = tcfg.init_params(tarch, tc, seed=1, device="cpu")
    assert torch.equal(again["layers"][3]["w2"], tp["layers"][3]["w2"])
    assert not torch.equal(other["embed"], tp["embed"])
    assert tp["embed"].abs().max() <= 2 * 0.02
    assert torch.count_nonzero(tp["layers"][0]["norm1"]) == 0


def test_layer_pattern_and_unported_kinds():
    _, (tarch, tcell, tc) = _setup()
    assert [tc.is_global(i) for i in range(6)] == [False] * 5 + [True]
    full = tcfg.resolve_config(tarch, tcell, smoke=False)
    assert sum(full.is_global(i) for i in range(full.n_layers)) == 4
    # the train kind is ported now (ROADMAP item 17a): no LM kind raises
    cell = tarch.cell("train_4k")
    _, takes_opt = tcfg.build_step(tarch, cell, tc)
    assert takes_opt and full.grad_accum == 2 and not tc.remat
    assert sorted(tcfg.make_batch(tarch, cell, tc, device="cpu")) == ["labels", "tokens"]
