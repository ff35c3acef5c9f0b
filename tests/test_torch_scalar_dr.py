"""The scalar match and ``plan_weight="dr"`` on the CPU: with the JAX
engine's weights carried across, the port's dr plans (paths and cost) are
the reference's, a repeated batch takes them from the plan cache and
probes only their paths, and ``match(q, impl="scalar")`` equals
``match_many(qs)[i]``, the reference's lists and VF2's sets, for both
joins (the reference's ``test_match_many_equals_scalar_property`` sweep)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import GnnPeConfig as RefConfig  # noqa: E402
from repro.core import GnnPeEngine as RefEngine  # noqa: E402
from repro.graphs import erdos_renyi, random_connected_query  # noqa: E402
from repro_torch.convert import partition_state_from_reference  # noqa: E402
from repro_torch.core import GnnPeConfig, GnnPeEngine, vf2_match  # noqa: E402
from repro_torch.core import index as PI  # noqa: E402
from repro_torch.graphs import Graph  # noqa: E402


def port_graph(g) -> Graph:
    return Graph(g.offsets, g.nbrs, g.labels)


def engines(g, **cfg):
    ref = RefEngine(RefConfig(**cfg)).build(g)
    port = GnnPeEngine(GnnPeConfig(**cfg), device="cpu").build(
        port_graph(g), params=partition_state_from_reference(ref.models)
    )
    return ref, port


def some_queries(g, n: int, seed0: int):
    out = []
    for s in range(n):
        try:
            out.append(random_connected_query(g, 4 + s % 3, seed=seed0 + s))
        except RuntimeError:
            continue
    return out


@pytest.fixture(scope="module")
def graph():
    return erdos_renyi(130, avg_degree=3.5, n_labels=4, seed=9)


@pytest.mark.parametrize("probe_impl", ["loop", "stacked"])
@pytest.mark.parametrize("quantize", [False, True])
def test_dr_plans_equal_reference_and_hit_the_cache(graph, quantize, probe_impl):
    cfg = dict(
        n_partitions=3, encoder="monotone", n_multi=1, block_size=32,
        plan_weight="dr", quantize_index=quantize, probe_impl=probe_impl,
    )
    ref, port = engines(graph, **cfg)
    qs = some_queries(graph, 6, seed0=900)
    assert all(port._dr_plan_peek(q) is None for q in qs)
    want, wst = ref.match_many(qs, return_stats=True)
    PI.reset_pair_counters()
    got, gst = port.match_many(qs, return_stats=True)
    cold_pairs = PI.PAIR_METRIC.get(kind="leaf_pairs")
    assert got == want and sum(map(len, got)) > 0
    for a, b in zip(gst, wst):
        assert a.plan.paths == b.plan.paths
        assert a.plan.cost == b.plan.cost
        assert a.plan.strategy == b.plan.strategy == "aip(dr)"
        assert a.n_candidates == b.n_candidates
    # the warm batch takes every plan from the cache and probes its paths only
    assert all(port._dr_plan_peek(q) is not None for q in qs)
    requests = []
    probe_batch = port._probe_batch

    def spy(reqs, *a, **k):
        requests.append(list(reqs))
        return probe_batch(reqs, *a, **k)

    port._probe_batch = spy
    PI.reset_pair_counters()
    again, ast = port.match_many(qs, return_stats=True)
    assert again == got
    assert [s.plan.paths for s in ast] == [s.plan.paths for s in gst]
    assert requests == [[(qi, p) for qi, s in enumerate(ast) for p in s.plan.paths]]
    assert 0 < PI.PAIR_METRIC.get(kind="leaf_pairs") < cold_pairs


def test_dr_cache_retires_with_a_new_build(graph):
    _, port = engines(graph, n_partitions=2, encoder="monotone", plan_weight="dr")
    q = some_queries(graph, 1, seed0=77)[0]
    port.match_many([q])
    assert port._dr_plan_peek(q) is not None
    key = port._dr_plan_key(q)[1]
    port.build(port_graph(graph))
    assert port._dr_plan_peek(q) is None
    assert port._dr_plan_key(q)[1] == key  # same content, same fingerprint


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_match_many_equals_scalar_property(seed):
    """The reference's sweep over random graphs and queries: the port's
    scalar match equals its batched lists, the reference's (batched and
    scalar) and VF2's sets, with both joins."""
    rng = np.random.default_rng(seed)
    g = erdos_renyi(
        int(rng.integers(60, 140)), avg_degree=3.5, n_labels=int(rng.integers(3, 6)), seed=seed
    )
    cfg = dict(
        n_partitions=int(rng.integers(1, 4)), encoder="monotone",
        n_multi=int(seed % 3), block_size=32,
        quantize_index=bool(seed % 2), plan_weight="dr" if seed == 3 else "deg",
    )
    ref, port = engines(g, **cfg)
    qs = some_queries(g, 5, seed0=100 * seed)
    assert qs
    pg = port_graph(g)
    for jimpl in ("numpy", "device"):
        batched = port.match_many(qs, join_impl=jimpl)
        assert batched == ref.match_many(qs, join_impl=jimpl)
        for qi, q in enumerate(qs):
            scalar = port.match(q, impl="scalar", join_impl=jimpl)
            assert scalar == ref.match(q, impl="scalar", join_impl=jimpl)
            if jimpl == "numpy":
                assert scalar == batched[qi], f"seed {seed} query {qi}"
            assert set(scalar) == set(vf2_match(pg, q)), f"seed {seed} query {qi}"


def test_scalar_stats_and_online_impl(graph):
    """The scalar path's plan and candidate counts are the reference's, and
    ``online_impl="scalar"`` makes it ``match``'s default."""
    cfg = dict(n_partitions=3, encoder="monotone", n_multi=2, block_size=32,
               quantize_index=True, plan_weight="dr", online_impl="scalar")
    ref, port = engines(graph, **cfg)
    for q in some_queries(graph, 3, seed0=40):
        got, st = port.match(q, return_stats=True)
        want, rst = ref.match(q, return_stats=True)
        assert got == want == port.match(q, impl="batched")
        assert st.plan.paths == rst.plan.paths and st.plan.cost == rst.plan.cost
        assert st.n_candidates == rst.n_candidates
        assert (st.total_paths, st.candidate_paths, st.n_matches) == (
            rst.total_paths, rst.candidate_paths, rst.n_matches,
        )
    with pytest.raises(ValueError, match="online impl"):
        port.match(q, impl="bogus")
