"""The slice as a whole: ``build`` → ``match_many`` on the CPU.

With the JAX engine's weights carried across, the port returns the JAX
engine's match lists (same order) for both encoders; with its own
weights, the match sets equal VF2's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import GnnPeConfig as RefConfig  # noqa: E402
from repro.core import GnnPeEngine as RefEngine  # noqa: E402
from repro.core import TrainConfig as RefTrainConfig  # noqa: E402
from repro.graphs import newman_watts_strogatz, random_connected_query  # noqa: E402
from repro_torch.convert import partition_state_from_reference  # noqa: E402
from repro_torch.core import GnnPeConfig, GnnPeEngine, TrainConfig, vf2_match  # noqa: E402
from repro_torch.core.index import PAIR_METRIC  # noqa: E402
from repro_torch.graphs import Graph  # noqa: E402
from repro_torch.kernels.dominance_scan import ops  # noqa: E402

CONFIGS = {
    "monotone": dict(n_partitions=3, theta=10, n_multi=2, encoder="monotone", seed=0),
    # a short training budget: some vertices fall back to all-ones, so the
    # fallback indices are carried across too
    "gat": dict(n_partitions=2, theta=10, n_multi=1, encoder="gat", seed=0),
}


@pytest.fixture(scope="module")
def graph():
    return newman_watts_strogatz(120, k=4, p=0.15, n_labels=5, seed=7)


def port_graph(g) -> Graph:
    return Graph(g.offsets, g.nbrs, g.labels)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def engines(request, graph):
    kind = request.param
    ref = RefEngine(
        RefConfig(**CONFIGS[kind], train=RefTrainConfig(max_epochs=8, check_every=4))
    ).build(graph)
    state = partition_state_from_reference(ref.models)
    port = GnnPeEngine(GnnPeConfig(**CONFIGS[kind]), device="cpu").build(
        port_graph(graph), params=state
    )
    return kind, ref, port


def queries(graph, n: int, seed0: int):
    return [random_connected_query(graph, 5 + s % 3, seed=seed0 + s) for s in range(n)]


def test_injected_params_give_the_reference_match_lists(graph, engines):
    kind, ref, port = engines
    qs = queries(graph, 8, seed0=0)
    launches = ops.LAUNCHES
    pairs_before = PAIR_METRIC.get(kind="leaf_pairs")
    got = port.match_many(qs)
    assert ops.LAUNCHES == launches, "the CPU path launches no kernel"
    assert PAIR_METRIC.get(kind="leaf_pairs") > pairs_before
    want = ref.match_many(qs)
    assert got == want
    assert sum(len(m) for m in got) > 0
    for q, m in zip(qs, got):
        assert set(m) == set(vf2_match(port_graph(graph), q))
    if kind == "gat":
        assert sum(m.n_fallback for m in port.models) > 0


def test_injected_params_give_the_reference_index(engines):
    _, ref, port = engines
    for rm, pm in zip(ref.models, port.models):
        np.testing.assert_array_equal(pm.index.paths.numpy(), rm.index.paths)
        np.testing.assert_allclose(pm.index.emb.numpy(), rm.index.emb, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(pm.members, rm.members)


def test_stats_and_single_match(graph, engines):
    _, ref, port = engines
    q = random_connected_query(graph, 6, seed=42)
    got, st = port.match(q, return_stats=True)
    want, rst = ref.match(q, return_stats=True)
    assert got == want
    assert st.plan.paths == rst.plan.paths
    assert st.n_candidates == rst.n_candidates
    assert (st.total_paths, st.candidate_paths, st.n_matches) == (
        rst.total_paths, rst.candidate_paths, rst.n_matches,
    )


@pytest.mark.parametrize("encoder", ["monotone", "gat"])
def test_own_params_match_vf2(graph, encoder):
    cfg = GnnPeConfig(
        n_partitions=2, n_multi=1, encoder=encoder, seed=3,
        train=TrainConfig(max_epochs=6, check_every=3),
    )
    g = port_graph(graph)
    eng = GnnPeEngine(cfg, device="cpu").build(g)
    qs = queries(graph, 5, seed0=300)
    for q, m in zip(qs, eng.match_many(qs)):
        assert set(m) == set(vf2_match(g, q))
        assert len(m) == len(set(m))


@pytest.mark.parametrize("fields,item", [({"cache": True}, "item 12")])
def test_later_slices_raise(fields, item):
    """No config value waits for a later slice any more: ``_LATER`` is empty
    and ``cache=True``, the last value there (ROADMAP queue 1 item 12),
    builds an engine with its result cache."""
    from repro_torch.core.engine import _LATER

    assert _LATER == {}
    eng = GnnPeEngine(GnnPeConfig(**fields), device="cpu")
    assert eng._result_cache is not None and eng._result_cache.capacity == 2048


@pytest.mark.parametrize(
    "fields",
    [{"plan_strategy": "oip"}, {"plan_strategy": "eip"}, {"induced": True},
     {"induced": True, "join_impl": "device"}],
)
def test_plan_strategies_and_induced_match_the_reference(graph, fields):
    """``plan_strategy`` oip / eip and engine-level ``induced=True`` (with
    both joins) give the reference engine's match lists and VF2's sets."""
    cfg = dict(CONFIGS["monotone"], **fields)
    ref = RefEngine(RefConfig(**cfg)).build(graph)
    port = GnnPeEngine(GnnPeConfig(**cfg), device="cpu").build(
        port_graph(graph), params=partition_state_from_reference(ref.models)
    )
    qs = queries(graph, 4, seed0=900)
    got = port.match_many(qs)
    assert got == ref.match_many(qs) and sum(map(len, got)) > 0
    g = port_graph(graph)
    for q, m in zip(qs, got):
        assert set(m) == set(vf2_match(g, q, induced=cfg.get("induced", False)))


@pytest.mark.parametrize(
    "fields",
    [
        {"index_kind": "grouped"},
        {"group_size_mode": "auto"},
        {"index_kind": "grouped", "probe_impl": "stacked"},
    ],
)
def test_grouped_configs_build_and_match_the_reference(graph, fields):
    """The config values the GNN-PGE slice brought build a port engine on
    the CPU whose match lists equal the reference engine's."""
    cfg = dict(CONFIGS["monotone"], **fields)
    ref = RefEngine(RefConfig(**cfg)).build(graph)
    port = GnnPeEngine(GnnPeConfig(**cfg), device="cpu").build(
        port_graph(graph), params=partition_state_from_reference(ref.models)
    )
    qs = queries(graph, 4, seed0=700)
    got = port.match_many(qs)
    assert got == ref.match_many(qs) and sum(map(len, got)) > 0
    assert port.offline_stats["group_sizes"] == ref.offline_stats["group_sizes"]


def test_every_reference_config_field_builds_the_port_config():
    """One dict builds both engines: every field of the reference's
    GnnPeConfig and TrainConfig, at its default, is a field of the port's."""
    import dataclasses

    ref_train = {f.name: getattr(RefTrainConfig(), f.name) for f in dataclasses.fields(RefTrainConfig)}
    train = TrainConfig(**ref_train)
    assert dataclasses.asdict(train) == ref_train
    ref = {f.name: getattr(RefConfig(), f.name) for f in dataclasses.fields(RefConfig)
           if f.name != "train"}
    cfg = GnnPeConfig(**ref, train=train)
    assert {name: getattr(cfg, name) for name in ref} == ref
    assert {f.name for f in dataclasses.fields(GnnPeConfig)} == set(ref) | {"train"}


@pytest.mark.parametrize("value", [None, True, False])
def test_use_pallas_scan_on_the_cpu(graph, value):
    """None takes K1's plain version on the CPU, False forces it, True
    forces K1, which a CPU engine cannot run."""
    cfg = dict(CONFIGS["monotone"], use_pallas_scan=value)
    if value:
        with pytest.raises(ValueError, match="needs a CUDA device"):
            GnnPeEngine(GnnPeConfig(**cfg), device="cpu")
        return
    g = port_graph(graph)
    qs = queries(graph, 6, seed0=500)
    launches = ops.LAUNCHES
    got = GnnPeEngine(GnnPeConfig(**cfg), device="cpu").build(g).match_many(qs)
    assert ops.LAUNCHES == launches
    want = GnnPeEngine(GnnPeConfig(**CONFIGS["monotone"]), device="cpu").build(g).match_many(qs)
    assert got == want
    assert sum(len(m) for m in got) > 0
