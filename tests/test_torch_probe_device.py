"""The stacked probe's device-resident hand-off to the device join, on the
CPU, held against the JAX package.

``StackedProbe.probe_device`` returns the reference's candidate vertex rows
per probe (slot order on the device branch, engine order on the fallback
past ``leaf_pair_cap``), its per-partition counts, stats and pair counters,
for both index kinds; and an engine whose stacked probe hands off to the
device join gives the reference engine's match lists (the device join's
order follows its candidates'), with ``deg`` and ``dr`` plans, and VF2's
sets."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import GnnPeConfig as RefConfig  # noqa: E402
from repro.core import GnnPeEngine as RefEngine  # noqa: E402
from repro.core import index as RI  # noqa: E402
from repro.dist.probe import StackedProbe as RefProbe  # noqa: E402
from repro.graphs import erdos_renyi, random_connected_query  # noqa: E402
from repro_torch.convert import partition_state_from_reference  # noqa: E402
from repro_torch.core import GnnPeConfig, GnnPeEngine, sort_matches, vf2_match  # noqa: E402
from repro_torch.core import index as PI  # noqa: E402
from repro_torch.dist import StackedProbe  # noqa: E402
from repro_torch.graphs import Graph  # noqa: E402
from test_torch_grouped import _t, indexes, queries  # noqa: E402


def run_both(cap: int, use_groups: bool, quantize: bool, n_gnn: int = 2, Q: int = 6,
             sizes=None):
    """``probe_device`` of the reference and the port on the same indexes →
    (ref probe, its output, its counters, port probe, its output, its
    counters, the port's inputs)."""
    kw = {} if sizes is None else dict(sizes=sizes)
    ref, port, vocab, rng = indexes(30 + quantize, quantize, n_gnn,
                                    group_sizes=(16, 8, 32) if use_groups else None, **kw)
    q_emb, q_emb0, q_multi, qh = queries(ref, vocab, rng, Q, n_gnn) if ref[0].n_paths else (
        np.zeros((len(ref), Q, 6), np.float32), np.zeros((len(ref), Q, 6), np.float32),
        np.zeros((n_gnn, len(ref), Q, 6), np.float32), np.zeros(Q, np.int64))
    RI.reset_pair_counters()
    ref_probe = RefProbe(ref, leaf_pair_cap=cap)
    want = ref_probe.probe_device(
        q_emb, q_emb0, q_multi, q_label_hash=qh if quantize else None, use_groups=use_groups,
        use_pallas=False, return_stats=True,
    )
    want_pairs = dict(RI.PAIR_COUNTERS)
    PI.reset_pair_counters()
    probe = StackedProbe(port, leaf_pair_cap=cap)
    args = (_t(q_emb), _t(q_emb0), _t(q_multi), _t(qh) if quantize else None)
    got = probe.probe_device(*args, use_groups=use_groups, return_stats=True)
    got_pairs = {k: PI.PAIR_METRIC.get(kind=k) for k in want_pairs}
    return ref_probe, want, want_pairs, probe, got, got_pairs, args


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("use_groups", [False, True])
@pytest.mark.parametrize("branch", ["device", "fallback"])
def test_probe_device_equals_reference(branch, use_groups, quantize):
    cap = 1 << 21 if branch == "device" else 7
    ref_probe, want, want_pairs, probe, got, got_pairs, args = run_both(cap, use_groups, quantize)
    per_probe, part_counts, stats = got
    assert len(per_probe) == len(want[0]) == args[0].shape[1]
    for g, (w, n) in zip(per_probe, want[0]):
        assert g.dtype == torch.int32 and g.shape == (n, 3)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:n])
    np.testing.assert_array_equal(part_counts, want[1])
    assert stats == want[2]
    assert got_pairs == want_pairs
    np.testing.assert_array_equal(probe.part_leaf_pairs, ref_probe.part_leaf_pairs)
    moved = int(branch == "fallback")
    assert probe.host_expansions == ref_probe.host_expansions == moved
    assert sum(g.shape[0] for g in per_probe) > 0
    # the same candidates as probe's rows: slot order on the device branch,
    # engine order on the fallback
    rows = probe.probe(*args, use_groups=use_groups)
    st = probe.stacked
    order = np.argsort(st.slot_of) if branch == "device" else np.arange(st.n_parts)
    for b, g in enumerate(per_probe):
        parts = [probe._indexes[i].paths[rows[i][b]] for i in order]
        assert torch.equal(g, torch.cat(parts).to(torch.int32))


def test_probe_device_all_empty_and_empty_batch():
    ref_probe, want, _, probe, got, _, args = run_both(1 << 21, True, True, sizes=[0, 0, 0])
    assert [tuple(g.shape) for g in got[0]] == [(n, 3) for _, n in want[0]]
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    per_probe, part_counts = probe.probe_device(*(a[:, :0] for a in args[:2]), None)
    assert per_probe == [] and part_counts.shape == (3, 0)
    ref, port, vocab, rng = indexes(4, False, 2)
    q = [_t(a) for a in queries(ref, vocab, rng, 4, 2)[:3]]
    with pytest.raises(ValueError, match="PackedGroupIndex sidecar"):
        StackedProbe(port).probe_device(*q, use_groups=True)


@pytest.fixture(scope="module")
def graph():
    return erdos_renyi(200, avg_degree=3.5, n_labels=4, seed=5)


@pytest.mark.parametrize("plan_weight", ["deg", "dr"])
def test_engine_hand_off_equals_reference(graph, plan_weight):
    """A path-kind engine of 5 partitions (slot order differs from engine
    order): every probe × join gives the reference engine's lists and
    VF2's sets; with the stacked probe the device join takes the hand-off,
    whose lists differ in order from the loop probe's device join, and the
    probe splits no rows per (partition, query)."""
    cfg = dict(n_partitions=5, encoder="monotone", n_multi=1, block_size=32,
               plan_weight=plan_weight, quantize_index=plan_weight == "dr")
    ref = RefEngine(RefConfig(**cfg)).build(graph)
    g = Graph(graph.offsets, graph.nbrs, graph.labels)
    eng = GnnPeEngine(GnnPeConfig(**cfg), device="cpu").build(
        g, params=partition_state_from_reference(ref.models)
    )
    assert list(eng.stacked_probe().stacked.slot_of) != list(range(5))
    qs = [random_connected_query(graph, 4 + s % 3, seed=50 + s) for s in range(5)]
    lists = {}
    for probe, join in itertools.product(("loop", "stacked"), ("numpy", "device")):
        before = eng.stacked_probe().host_expansions
        lists[probe, join] = eng.match_many(qs, probe_impl=probe, join_impl=join)
        assert lists[probe, join] == ref.match_many(qs, probe_impl=probe, join_impl=join)
        assert [set(m) for m in lists[probe, join]] == [set(vf2_match(g, q)) for q in qs]
        if (probe, join) == ("stacked", "device"):
            assert eng.stacked_probe().host_expansions == before
    hand_off, loop = lists["stacked", "device"], lists["loop", "device"]
    assert hand_off != loop
    assert [sort_matches(m) for m in hand_off] == [sort_matches(m) for m in loop]
    assert sum(map(len, hand_off)) > 0


def test_engine_probe_batch_fills_the_device_memo(graph):
    """``_probe_batch`` with ``dev_memo``: the memo stays empty; each probe's
    device tensor holds the loop memo's rows' vertices in slot order, its
    counts per partition those of the loop memo."""
    eng = GnnPeEngine(GnnPeConfig(n_partitions=5, encoder="monotone", block_size=32,
                                  probe_impl="stacked"), device="cpu").build(
        Graph(graph.offsets, graph.nbrs, graph.labels)
    )
    qs = [random_connected_query(graph, 5, seed=70 + s) for s in range(3)]
    q_embs = eng._query_node_embeddings_many(qs)
    reqs = [(qi, p) for qi, q in enumerate(qs) for p in eng._deg_plan_cached(q).paths]
    memo, dev_memo, dev_counts, loop = {}, {}, {}, {}
    eng._probe_batch(reqs, q_embs, memo, qs, "stacked", dev_memo=dev_memo, dev_counts=dev_counts)
    eng._probe_batch(reqs, q_embs, loop, qs, "loop")
    assert memo == {} and set(dev_memo) == set(dict.fromkeys(reqs))
    slots = np.argsort(eng.stacked_probe().stacked.slot_of)
    for qi, p in dev_memo:
        want = [eng.models[mi].index.paths[loop[(mi, qi, p)]] for mi in slots]
        assert torch.equal(dev_memo[(qi, p)], torch.cat(want).to(torch.int32))
        for mi in range(5):
            assert dev_counts[(mi, qi, p)] == loop[(mi, qi, p)].numel()


def test_engine_hand_off_fallback_equals_reference(graph):
    """Past ``stacked_leaf_pair_cap`` the hand-off takes the chunked probe
    and engine order, as the reference does: the same lists."""
    cfg = dict(n_partitions=5, encoder="monotone", n_multi=1, block_size=32,
               index_kind="grouped", group_size=8, stacked_leaf_pair_cap=5,
               probe_impl="stacked", join_impl="device")
    ref = RefEngine(RefConfig(**cfg)).build(graph)
    eng = GnnPeEngine(GnnPeConfig(**cfg), device="cpu").build(
        Graph(graph.offsets, graph.nbrs, graph.labels),
        params=partition_state_from_reference(ref.models),
    )
    qs = [random_connected_query(graph, 4 + s % 3, seed=50 + s) for s in range(4)]
    for kind in ("path", "grouped"):
        before = eng.stacked_probe().host_expansions
        assert eng.match_many(qs, index_kind=kind) == ref.match_many(qs, index_kind=kind)
        assert eng.stacked_probe().host_expansions > before
