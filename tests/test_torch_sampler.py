"""The port's fanout sampler (``repro_torch.graphs.sample_fanout``, a NumPy
copy) against the JAX package's: the same graph, seeds, fanouts and
``default_rng`` seed give identical arrays, layer for layer."""
import numpy as np
import pytest

from repro.graphs import erdos_renyi as j_er
from repro.graphs import newman_watts_strogatz as j_nws
from repro.graphs.sampler import sample_fanout as j_sample
from repro_torch.graphs import SampledBatch, erdos_renyi, newman_watts_strogatz, sample_fanout


@pytest.mark.parametrize("gen,fanouts,seed", [
    ("er", (3, 2), 0),
    ("er", (15, 10), 1),  # minibatch_lg's fanouts: most rows keep every neighbour
    ("nws", (2, 2, 1), 2),
    ("nws", (4,), 3),
])
def test_sample_fanout_identical_to_the_reference(gen, fanouts, seed):
    if gen == "er":
        g, jg = erdos_renyi(300, avg_degree=6, seed=seed), j_er(300, avg_degree=6, seed=seed)
    else:
        g = newman_watts_strogatz(200, k=4, p=0.2, seed=seed)
        jg = j_nws(200, k=4, p=0.2, seed=seed)
    assert np.array_equal(g.nbrs, jg.nbrs) and np.array_equal(g.offsets, jg.offsets)
    seeds = np.random.default_rng(seed).choice(g.n_vertices, 16, replace=False)
    got, want = sample_fanout(g, seeds, fanouts, seed=seed), j_sample(jg, seeds, fanouts, seed=seed)
    assert isinstance(got, SampledBatch)
    assert np.array_equal(got.seeds, want.seeds)
    assert len(got.vertex_ids) == len(want.vertex_ids) == len(fanouts) + 1
    for a, b in zip(got.vertex_ids, want.vertex_ids):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(got.blocks, want.blocks):
        assert (a.n_dst, a.fanout) == (b.n_dst, b.fanout)
        assert a.nbr_index.dtype == b.nbr_index.dtype and np.array_equal(a.nbr_index, b.nbr_index)
        assert np.array_equal(a.mask, b.mask)
