"""Join and refine: the port's device sort-merge join returns the JAX
package's tables row for row, with one-word keys and past 63 key bits
(where the reference sorts void bytes and the port ranks rows), with and
without the dedup sorts."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.matcher import join_candidates as ref_join  # noqa: E402
from repro.core.matcher import refine as ref_refine  # noqa: E402
from repro.graphs import newman_watts_strogatz, random_connected_query  # noqa: E402
from repro_torch.core.matcher import join_candidates, refine  # noqa: E402
from repro_torch.graphs import Graph, device_graph  # noqa: E402

PLAN = [(0, 1, 2), (2, 3, 4), (1, 5, 6), (4, 7, 0), (8, 9, 10)]  # the last is disjoint


def candidates(n_values: int, seed: int, rows: int = 60):
    """Candidates over a small id pool (so joins hit), with duplicates and
    ids near ``n_values`` (so wide keys use their high bits)."""
    rng = np.random.default_rng(seed)
    pool = np.concatenate([np.arange(12), n_values - 1 - np.arange(4)])
    out = []
    for p in PLAN:
        c = rng.choice(pool, (rows + 7 * len(out), len(p))).astype(np.int32)
        c[-5:] = c[:5]  # duplicate rows
        out.append(c)
    return out


@pytest.mark.parametrize("n_values", [16, 1 << 22, (1 << 31) - 1])
@pytest.mark.parametrize("assume_unique", [False, True])
def test_join_tables_equal_reference(n_values, assume_unique):
    for seed in range(3):
        cands = candidates(n_values, seed)
        if assume_unique:
            cands = [np.unique(c, axis=0) for c in cands]
        plan = PLAN[:4] if seed < 2 else PLAN  # seed 2 adds a cartesian step
        want, want_cols = ref_join(plan, cands[: len(plan)], n_values, assume_unique=assume_unique)
        got, cols = join_candidates(
            plan, [torch.from_numpy(c.astype(np.int64)) for c in cands[: len(plan)]],
            n_values, assume_unique=assume_unique,
        )
        assert cols == want_cols and want.shape[0] > 0
        np.testing.assert_array_equal(got.numpy(), want)


def test_refine_equals_reference():
    g = newman_watts_strogatz(200, k=6, p=0.2, n_labels=3, seed=5)
    pg = Graph(g.offsets, g.nbrs, g.labels)
    q = random_connected_query(g, 4, seed=1)
    rng = np.random.default_rng(0)
    table = rng.integers(0, 200, (5000, 4)).astype(np.int32)
    # plant some true embeddings among the random rows
    from repro.core.baselines import vf2_match

    true = np.asarray(vf2_match(g, q)[:20], np.int32)
    table[: true.shape[0]] = true[:, [2, 0, 3, 1]]
    cols = [2, 0, 3, 1]
    for induced in (False, True):
        want = ref_refine(g, q, table, cols, induced=induced)
        got = refine(pg, device_graph(pg, "cpu"), q, torch.from_numpy(table.astype(np.int64)),
                     cols, induced=induced)
        assert got == want
        assert len(got) >= (0 if induced else true.shape[0])


def test_baselines_agree_with_vf2():
    from repro_torch.core import gql_match, quicksi_match, vf2_match
    from repro_torch.graphs import newman_watts_strogatz as nws
    from repro_torch.graphs import random_connected_query as rcq

    g = nws(120, k=4, p=0.15, n_labels=5, seed=7)
    for s in range(3):
        q = rcq(g, 5, seed=400 + s)
        assert set(vf2_match(g, q)) == set(quicksi_match(g, q)) == set(gql_match(g, q))
