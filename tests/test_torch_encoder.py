"""Encoders and Alg. 2 training: with the JAX package's params the port's
embeddings lie within 1e-6 of the reference's (``exp``, ``softmax`` and
the contraction order differ by an ulp between XLA and ATen); a star
embeds to the same bits alone or in any batch; training on the port's
own init ends violation-free or with the all-ones fallback."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.encoder import EncoderConfig as RefEncoderConfig  # noqa: E402
from repro.core.encoder import make_encoder as ref_make_encoder  # noqa: E402
from repro.core.stars import build_star_tensors as ref_stars  # noqa: E402
from repro_torch.core.encoder import EncoderConfig, make_encoder  # noqa: E402
from repro_torch.core.stars import build_pair_dataset, build_star_tensors  # noqa: E402
from repro_torch.core.training import (  # noqa: E402
    TrainConfig,
    dominance_violations,
    train_dominance,
)
from repro_torch.graphs import device_graph, newman_watts_strogatz  # noqa: E402

TOL = 1e-6


def _setup(kind: str, seed: int):
    g = newman_watts_strogatz(150, k=6, p=0.2, n_labels=7, seed=seed)
    cfg = dict(n_labels=7, theta=6, kind=kind)
    ref = ref_make_encoder(RefEncoderConfig(**cfg))
    rparams = ref.init(jax.random.PRNGKey(seed))
    enc = make_encoder(EncoderConfig(**cfg))
    params = {k: torch.tensor(np.asarray(v)) for k, v in rparams.items()}
    vs = np.arange(150)
    return g, vs, ref, rparams, enc, params


@pytest.mark.parametrize("kind", ["monotone", "gat"])
@pytest.mark.parametrize("seed", [0, 3])
def test_embeddings_match_reference(kind, seed):
    g, vs, ref, rparams, enc, params = _setup(kind, seed)
    rst = ref_stars(g, vs, 6)
    st = build_star_tensors(device_graph(g, "cpu"), vs, 6)
    want = np.asarray(ref.embed_stars(rparams, rst.center_labels, rst.leaf_labels, rst.leaf_mask))
    got = enc.embed_stars(params, st.center_labels, st.leaf_labels, st.leaf_mask).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # the substructures (every other leaf dropped) as well
    sub = rst.leaf_mask & (np.arange(6)[None, :] % 2 == 0)
    want = np.asarray(ref.embed_stars(rparams, rst.center_labels, rst.leaf_labels, sub))
    got = enc.embed_stars(params, st.center_labels, st.leaf_labels, torch.from_numpy(sub))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    want0 = np.asarray(ref.embed_isolated(rparams, rst.center_labels))
    got0 = enc.embed_isolated(params, st.center_labels).numpy()
    np.testing.assert_allclose(got0, want0, rtol=0, atol=TOL)


@pytest.mark.parametrize("kind", ["monotone", "gat"])
def test_row_independence(kind):
    """A vertex embeds to the same bits alone, in any batch, and under a
    stack of partition models (the query path's partition dim)."""
    g, vs, _, _, enc, params = _setup(kind, 1)
    st = build_star_tensors(device_graph(g, "cpu"), vs, 6)
    args = (st.center_labels, st.leaf_labels, st.leaf_mask)
    batch = enc.embed_stars(params, *args)
    for i in (0, 17, 149):
        alone = enc.embed_stars(params, *(a[i : i + 1] for a in args))
        assert torch.equal(alone[0], batch[i])
    sub = enc.embed_stars(params, *(a[40:77] for a in args))
    assert torch.equal(sub, batch[40:77])
    stacked = {k: torch.stack([v, v * 0.5]) for k, v in params.items()}
    both = enc.embed_stars(stacked, *args)
    assert torch.equal(both[0], batch)
    half = enc.embed_stars({k: v * 0.5 for k, v in params.items()}, *args)
    assert torch.equal(both[1], half)


@pytest.mark.parametrize("kind", ["monotone", "gat"])
def test_training_never_leaves_a_violated_pair(kind):
    g = newman_watts_strogatz(60, k=4, p=0.2, n_labels=4, seed=2)
    st = build_star_tensors(device_graph(g, "cpu"), np.arange(30), 5)
    pairs = build_pair_dataset(st, rng=np.random.default_rng(0))
    cfg = EncoderConfig(n_labels=4, theta=5, kind=kind)
    res = train_dominance(cfg, st, pairs, TrainConfig(max_epochs=12, check_every=4))
    viol = dominance_violations(make_encoder(cfg), res.params, st, pairs)
    bad = set(pairs.star_idx[viol].tolist())
    assert bad <= set(res.fallback_vertices.tolist())
    assert res.final_violations == int(viol.sum())
    if kind == "monotone":
        assert res.epochs == 0 and not bad
    else:
        assert len(res.loss_history) == res.epochs
