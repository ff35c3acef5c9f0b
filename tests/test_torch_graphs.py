"""Graph substrate, stars, pairs and paths: the port gives the JAX
package's arrays exactly, for several seeds."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.paths import concat_path_embeddings as ref_concat  # noqa: E402
from repro.core.paths import enumerate_paths as ref_paths  # noqa: E402
from repro.core.stars import build_pair_dataset as ref_pairs  # noqa: E402
from repro.core.stars import build_star_tensors as ref_stars  # noqa: E402
from repro.graphs import erdos_renyi as ref_er  # noqa: E402
from repro.graphs import expanded_partition as ref_expand  # noqa: E402
from repro.graphs import newman_watts_strogatz as ref_nws  # noqa: E402
from repro.graphs import partition_graph as ref_partition  # noqa: E402
from repro.graphs import random_connected_query as ref_query  # noqa: E402
from repro_torch.core.paths import concat_path_embeddings, enumerate_paths  # noqa: E402
from repro_torch.core.stars import build_pair_dataset, build_star_tensors  # noqa: E402
from repro_torch.graphs import (  # noqa: E402
    device_graph,
    erdos_renyi,
    expanded_partition,
    newman_watts_strogatz,
    partition_graph,
    random_connected_query,
)


def assert_graph_equal(a, b):
    for f in ("offsets", "nbrs", "labels"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_generators_and_partitions_identical(seed):
    g = newman_watts_strogatz(400, k=4, p=0.15, n_labels=9, seed=seed)
    rg = ref_nws(400, k=4, p=0.15, n_labels=9, seed=seed)
    assert_graph_equal(g, rg)
    assert_graph_equal(erdos_renyi(200, 3.0, 5, seed=seed), ref_er(200, 3.0, 5, seed=seed))
    for s in range(3):
        assert_graph_equal(random_connected_query(g, 6, seed=s), ref_query(rg, 6, seed=s))
    assert_graph_equal(
        random_connected_query(g, 8, seed=seed, avg_degree=2.0),
        ref_query(rg, 8, seed=seed, avg_degree=2.0),
    )
    part, rpart = partition_graph(g, 3, seed=seed), ref_partition(rg, 3, seed=seed)
    np.testing.assert_array_equal(part.assignment, rpart.assignment)
    for j in range(3):
        np.testing.assert_array_equal(
            expanded_partition(g, part, j, 2), ref_expand(rg, rpart, j, 2)
        )


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("theta", [3, 10])
def test_stars_and_pairs_identical(seed, theta):
    g = newman_watts_strogatz(300, k=6, p=0.2, n_labels=7, seed=seed)
    vs = np.sort(np.random.default_rng(seed).choice(300, 120, replace=False))
    st = build_star_tensors(device_graph(g, "cpu"), vs, theta)
    rst = ref_stars(g, vs, theta)
    for f in ("centers", "center_labels", "leaf_labels", "leaf_mask", "overflow"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), getattr(rst, f))
    assert rst.overflow.any() or theta > 3  # θ = 3 exercises the overflow stars
    pairs = build_pair_dataset(st, rng=np.random.default_rng(seed + 3))
    rpairs = ref_pairs(rst, rng=np.random.default_rng(seed + 3))
    np.testing.assert_array_equal(pairs.star_idx.numpy(), rpairs.star_idx)
    np.testing.assert_array_equal(pairs.subset_mask.numpy(), rpairs.subset_mask)
    unshuffled = build_pair_dataset(st)
    np.testing.assert_array_equal(unshuffled.star_idx.numpy(), ref_pairs(rst).star_idx)


@pytest.mark.parametrize("length", [0, 1, 2, 3])
def test_paths_and_path_embeddings_identical(length):
    g = newman_watts_strogatz(200, k=4, p=0.1, n_labels=5, seed=length)
    roots = np.arange(0, 200, 3)
    paths = enumerate_paths(device_graph(g, "cpu"), roots, length)
    rpaths = ref_paths(g, roots, length)
    np.testing.assert_array_equal(paths.numpy(), rpaths)
    emb = np.random.default_rng(length).random((200, 2), dtype=np.float32)
    np.testing.assert_array_equal(
        concat_path_embeddings(paths, torch.from_numpy(emb)).numpy(), ref_concat(rpaths, emb)
    )
