"""Live updates on the port (``core/delta.py`` and the engine's update
path), held against the JAX package on the CPU.

The graph edits give array-equal graphs, touched sets and kept paths; the
delta state, the compacted indexes (group sidecar included) and a
re-stacked slot are field-equal to the reference's; the buffers' probe
gives its row lists; and at every epoch of a random update stream the
port's match lists equal the reference engine's (both joins, the scalar
match), their sets equal VF2's and a from-scratch rebuild's.  Engines are
built from the reference's weights (``convert``) on its 150-vertex graph
in 3 partitions."""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import GnnPeConfig as RefConfig  # noqa: E402
from repro.core import GnnPeEngine as RefEngine  # noqa: E402
from repro.core import delta as RD  # noqa: E402
from repro.graphs import erdos_renyi, from_edge_list, random_connected_query  # noqa: E402
from repro_torch.convert import partition_state_from_reference  # noqa: E402
from repro_torch.core import GnnPeConfig, GnnPeEngine, sort_matches, vf2_match  # noqa: E402
from repro_torch.core import delta as PD  # noqa: E402
from repro_torch.graphs import Graph  # noqa: E402
from repro_torch.graphs import from_edge_list as port_from_edge_list  # noqa: E402
from repro_torch.kernels.dominance_scan import ops  # noqa: E402


def port_graph(g) -> Graph:
    return Graph(g.offsets, g.nbrs, g.labels)


@pytest.fixture(scope="module")
def graph():
    return erdos_renyi(150, avg_degree=3.5, n_labels=4, seed=5)


def engines(g, n_port: int = 1, **fields):
    """The reference engine and ``n_port`` port engines of one config, the
    port's built from the reference's weights."""
    cfg = dict(dict(n_partitions=3, encoder="monotone", n_multi=1, block_size=32, group_size=4),
               **fields)
    ref = RefEngine(RefConfig(**cfg)).build(g)
    state = partition_state_from_reference(ref.models)
    ports = [
        GnnPeEngine(GnnPeConfig(**cfg), device="cpu").build(port_graph(g), params=state)
        for _ in range(n_port)
    ]
    return ref, ports


def rand_update(rng, g, add=2, remove=2, add_vertices=0, remove_vertices=0):
    """One seeded edit batch → (the reference's GraphUpdate, the port's)."""
    e = g.edge_array()
    arrays = {
        "add_edges": rng.integers(0, g.n_vertices, size=(add, 2)),
        "remove_edges": e[rng.choice(e.shape[0], size=remove, replace=False)],
        "add_vertex_labels": rng.integers(0, 4, size=add_vertices).astype(np.int32),
        "remove_vertices": rng.integers(0, g.n_vertices, size=remove_vertices),
    }
    return RD.GraphUpdate.from_arrays(arrays), PD.GraphUpdate.from_arrays(arrays)


def queries(g, n=3, seed0=50):
    return [random_connected_query(g, 4 + s % 3, seed=seed0 + s) for s in range(n)]


def assert_index_equal(got, want):
    """A port PackedIndex field-equal to a reference one: the paths and the
    integer sidecars exactly, the float fields as the port's build holds
    them (``test_torch_engine``)."""
    np.testing.assert_array_equal(got.paths.numpy(), want.paths)
    for name in ("emb", "emb0", "emb_multi"):
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(want, name), rtol=0,
                                   atol=1e-6)
    for name in ("emb_q", "label_hash"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), b)
    assert len(got.levels) == len(want.levels)
    for lg, lw in zip(got.levels, want.levels):
        for k in ("mbr", "mbr0", "mbr_multi"):
            np.testing.assert_allclose(lg[k].numpy(), lw[k], rtol=0, atol=1e-6)
    assert (got.groups is None) == (want.groups is None)
    if got.groups is not None:
        assert got.groups.group_size == want.groups.group_size
        for k in ("group_start", "block_group_start"):
            np.testing.assert_array_equal(getattr(got.groups, k).numpy(), getattr(want.groups, k))
        for k in ("mbr_hi", "mbr0"):
            np.testing.assert_allclose(getattr(got.groups, k).numpy(), getattr(want.groups, k),
                                       rtol=0, atol=1e-6)
    assert got.nbytes() == want.nbytes()


def assert_delta_equal(got, want):
    """The port's DeltaIndex field-equal to the reference's."""
    assert got.stats() == want.stats()
    for pg, pw in zip(got.parts, want.parts):
        np.testing.assert_array_equal(pg.tombstone.numpy(), pw.tombstone)
        np.testing.assert_array_equal(pg.paths.numpy(), pw.paths)
        assert (pg.n_tomb, pg.version) == (pw.n_tomb, pw.version)
        for name in ("emb", "emb0", "emb_multi"):
            np.testing.assert_allclose(getattr(pg, name).numpy(), getattr(pw, name), rtol=0,
                                       atol=1e-6)
        for name in ("emb_q", "label_hash"):
            a, b = getattr(pg, name), getattr(pw, name)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), b)


def assert_stacked_equal(got, want):
    np.testing.assert_array_equal(got.slot_of, want.slot_of)
    np.testing.assert_array_equal(got.n_paths.numpy(), want.n_paths)
    for name in ("level_hi", "level_lo0", "level_hi0"):
        assert len(getattr(got, name)) == len(getattr(want, name))
        for a, b in zip(getattr(got, name), getattr(want, name)):
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6)
    for name in ("emb_cat", "emb0", "emb_q", "label_hash"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6)
    assert (got.groups is None) == (want.groups is None)
    if got.groups is not None:
        for name in ("hi", "lo0", "hi0", "start", "count"):
            np.testing.assert_allclose(getattr(got.groups, name).numpy(),
                                       getattr(want.groups, name), rtol=0, atol=1e-6)
    assert got.padding_stats() == want.padding_stats()


# ------------------------------------------------------------ graph edits ----


def test_graph_edits_equal_reference(graph):
    """``apply_graph_update``, ``l_hop_reach``, ``paths_touching`` and
    ``touch_hint`` give the reference's arrays, on hand-made edge cases and
    on a seeded stream over the test graph."""
    small = from_edge_list(4, [(0, 1), (1, 2), (2, 3)], np.array([0, 1, 2, 1]))
    cases = [
        {"add_edges": np.array([[0, 1]]), "remove_edges": np.array([[0, 3]])},  # no-ops
        {"add_edges": np.array([[0, 3]]), "remove_edges": np.array([[1, 2]])},
        {"add_vertex_labels": np.array([3], np.int32), "add_edges": np.array([[4, 0]]),
         "remove_vertices": np.array([2])},
    ]
    streams = [(small, [(RD.GraphUpdate(**c), PD.GraphUpdate(**c)) for c in cases])]
    rng = np.random.default_rng(4)
    g, ups = graph, []
    for k in range(5):
        ru, pu = rand_update(rng, g, add=3, remove=3, add_vertices=k % 2,
                             remove_vertices=int(k % 3 == 2))
        ups.append((ru, pu))
        g, _ = RD.apply_graph_update(g, ru)
    streams.append((graph, ups))
    for g0, stream in streams:
        rg, pg = g0, port_graph(g0)
        for ru, pu in stream:
            for k, v in pu.to_arrays().items():
                np.testing.assert_array_equal(v, ru.to_arrays()[k])
            rg, rt = RD.apply_graph_update(rg, ru)
            pg, pt = PD.apply_graph_update(pg, pu)
            for name in ("offsets", "nbrs", "labels"):
                np.testing.assert_array_equal(getattr(pg, name), getattr(rg, name))
            np.testing.assert_array_equal(pt, rt)
            for a, b in zip(PD.touch_hint(pu), RD.touch_hint(ru)):
                np.testing.assert_array_equal(a, b)
            for hops in (1, 2):
                np.testing.assert_array_equal(
                    PD.l_hop_reach(pg, pt[:3], hops), RD.l_hop_reach(rg, rt[:3], hops)
                )
    chain = port_from_edge_list(6, [(0, 1), (1, 2), (2, 3), (3, 4)], np.zeros(6, np.int32))
    assert PD.l_hop_reach(chain, np.array([2]), 2).tolist() == [0, 1, 2, 3, 4]
    paths = np.array([[0, 1, 2], [3, 4, 3], [5, 5, 5]], np.int32)
    touched = np.array([2, 4])
    want = RD.paths_touching(paths, touched)
    np.testing.assert_array_equal(PD.paths_touching(paths, touched), want)
    on_tensor = PD.paths_touching(torch.from_numpy(paths).long(), touched)
    np.testing.assert_array_equal(on_tensor.numpy(), want)
    assert PD.paths_touching(torch.zeros((0, 3), dtype=torch.int64), touched).shape == (0,)
    with pytest.raises(ValueError, match="out of range"):
        PD.apply_graph_update(port_graph(small), PD.GraphUpdate(add_edges=np.array([[0, 9]])))


# ------------------------------------------------ delta ≡ reference ≡ rebuild ----


@pytest.mark.parametrize(
    "kind,impl,quantize,plan_weight",
    [
        ("path", "loop", False, "deg"),
        ("path", "stacked", True, "deg"),
        ("grouped", "loop", True, "dr"),
        ("grouped", "stacked", False, "deg"),
    ],
)
def test_delta_equals_reference_and_rebuild(graph, kind, impl, quantize, plan_weight):
    """Three epochs of random edge edits, the first also appending a vertex
    (compaction off), the next two with compaction forced, the last also
    removing a vertex: at every epoch the port's lists equal the reference
    delta engine's for both joins, its sets VF2's and a rebuild's; the delta
    state, every compacted index and the stacked layout are field-equal to
    the reference's; the scalar match agrees at the end."""
    ref, (eng, reb) = engines(
        graph, 2, index_kind=kind, probe_impl=impl, quantize_index=quantize,
        plan_weight=plan_weight, delta_compact_min=10**9,
    )
    rng = np.random.default_rng([("path", "grouped").index(kind), ("loop", "stacked").index(impl)])
    qs = queries(graph)
    compacted = 0
    for epoch in range(3):
        if epoch == 1:  # compaction pressure from now on
            tight = dict(delta_compact_min=8, delta_compact_frac=0.01)
            ref.cfg = dataclasses.replace(ref.cfg, **tight)
            eng.cfg = dataclasses.replace(eng.cfg, **tight)
        ru, pu = rand_update(rng, eng.graph, add_vertices=int(epoch == 0),
                             remove_vertices=int(epoch == 2))
        want_s = ref.apply_updates(ru)
        s = eng.apply_updates(pu)
        reb.apply_updates(pu, strategy="rebuild")
        assert s == want_s and s["epoch"] == epoch + 1
        compacted += len(s["compacted"])
        assert_delta_equal(eng.delta, ref.delta)
        for mi in s["compacted"]:
            assert_index_equal(eng.models[mi].index, ref.models[mi].index)
        if impl == "stacked":
            assert (eng._stacked_probe is None) == (ref._stacked_probe is None)
            if eng._stacked_probe is not None:
                assert_stacked_equal(eng._stacked_probe.stacked, ref._stacked_probe.stacked)
        rebuilt = [sort_matches(m) for m in reb.match_many(qs)]
        for join in ("numpy", "device"):
            got = eng.match_many(qs, join_impl=join)
            assert got == ref.match_many(qs, join_impl=join), f"epoch {epoch}, {join} join"
            assert [sort_matches(m) for m in got] == rebuilt
            for q, m in zip(qs, got):
                assert set(m) == set(vf2_match(eng.graph, q))
        if epoch >= 1:
            assert s["compacted"], "the forced threshold did not compact"
    assert compacted and sum(map(len, got)) > 0
    for q in qs:
        assert eng.match(q, impl="scalar") == ref.match(q, impl="scalar")


def test_delta_buffers_probed_without_compaction(graph):
    """Compaction off: the candidates come from main ∪ delta − tombstones
    (buffers and tombstones stay) through both probes and both joins: the
    reference's lists with the host join, a rebuild's sets with each."""
    ref, (eng, reb) = engines(graph, 2, delta_compact_min=10**9)
    rng = np.random.default_rng(7)
    qs = queries(graph)
    for _ in range(3):
        ru, pu = rand_update(rng, eng.graph, add=3, remove=3)
        ref.apply_updates(ru)
        eng.apply_updates(pu)
        reb.apply_updates(pu, strategy="rebuild")
    st = eng.delta_stats()
    assert st["delta_rows"] > 0 and st["tombstones"] > 0 and st["n_compactions"] == 0
    assert st == ref.delta_stats()
    rebuilt = [sort_matches(m) for m in reb.match_many(qs)]
    for probe, join in itertools.product(("loop", "stacked"), ("numpy", "device")):
        got = eng.match_many(qs, probe_impl=probe, join_impl=join)
        if join == "numpy":  # the device joins' lists: the property test above
            assert got == ref.match_many(qs, probe_impl=probe), probe
        assert [sort_matches(m) for m in got] == rebuilt
    # the main rows of every probe are live
    q_embs = eng._query_node_embeddings_many(qs)
    reqs = [(qi, p) for qi, q in enumerate(qs) for p in eng._deg_plan_cached(q).paths]
    memo, delta_memo = {}, {}
    eng._probe_batch(reqs, q_embs, memo, qs, "loop", delta_memo=delta_memo)
    assert delta_memo and any(r.numel() for r in delta_memo.values())
    for (mi, _, _), rows in memo.items():
        assert not eng.delta.parts[mi].tombstone[rows].any()


@pytest.mark.parametrize("quantize", [False, True])
def test_probe_delta_multi_equals_reference(graph, quantize):
    """The buffers' probe on real delta state: the reference's row lists
    per (partition, query), in order, for any pair cap (chunks)."""
    ref, (eng,) = engines(graph, quantize_index=quantize, delta_compact_min=10**9)
    rng = np.random.default_rng(11)
    for _ in range(3):
        ru, pu = rand_update(rng, eng.graph, add=4, remove=4)
        ref.apply_updates(ru)
        eng.apply_updates(pu)
    qs = queries(graph, n=4)
    q_embs = eng._query_node_embeddings_many(qs)
    cat, spans, _ = q_embs
    reqs = [(qi, p) for qi, q in enumerate(qs) for p in eng._deg_plan_cached(q).paths]
    gidx = np.asarray([spans[qi] + np.asarray(p) for qi, p in reqs])
    labels = np.concatenate([q.labels for q in qs]).astype(np.int64)
    qh = RD.hash_labels(labels[gidx]) if quantize else None
    mis = [mi for mi, dp in enumerate(eng.delta.parts) if dp.n_rows]
    assert mis
    B = len(reqs)
    items, ref_items = [], []
    g_t = torch.as_tensor(gidx)
    for mi in mis:
        o, o0, om = cat[mi]
        o, o0, om = o[g_t].reshape(B, -1), o0[g_t].reshape(B, -1), om[:, g_t].reshape(1, B, -1)
        items.append((eng.delta.parts[mi], o, o0, om, torch.as_tensor(qh) if quantize else None))
        ref_items.append((ref.delta.parts[mi], o.numpy(), o0.numpy(), om.numpy(), qh))
    want = RD.probe_delta_multi(ref_items, use_pallas=False)
    launches = ops.LAUNCHES
    for cap in (1 << 21, 37):
        got = PD.probe_delta_multi(items, pair_cap=cap)
        assert len(got) == len(want)
        for g_rows, w_rows in zip(got, want):
            assert len(g_rows) == len(w_rows) == B
            for a, b in zip(g_rows, w_rows):
                assert a.dtype == torch.int64
                np.testing.assert_array_equal(a.numpy(), b)
    assert sum(r.numel() for rows in got for r in rows) > 0
    # the scalar match's plain verdict gives the same rows
    from repro_torch.kernels.dominance_scan.ref import dominance_scan_pairs_indexed_ref

    plain = PD.probe_delta_multi(items, verdict=dominance_scan_pairs_indexed_ref)
    assert all(torch.equal(a, b) for x, y in zip(plain, got) for a, b in zip(x, y))
    assert ops.LAUNCHES == launches, "the CPU path launches no kernel"


def test_elastic_restack_only_touches_compacted_slot(graph):
    """Compaction under a stacked probe rewrites only the compacted
    partitions' slots (the probe object stays, the other slots' tensors keep
    their values) and the layout equals the reference's; both probes' lists
    equal the reference's, the hand-off's sets theirs."""
    ref, (eng,) = engines(graph, index_kind="grouped", quantize_index=True, probe_impl="stacked",
                          delta_compact_min=8, delta_compact_frac=0.01)
    probe = eng._stacked_probe
    rng = np.random.default_rng(3)
    qs = queries(graph)
    updated = 0
    for _ in range(3):
        st = probe.stacked
        before = [t.clone() for t in (st.emb_cat, st.groups.hi, st.level_hi[-1])]
        ru, pu = rand_update(rng, eng.graph, add=3, remove=3)
        ref.apply_updates(ru)
        s = eng.apply_updates(pu)
        assert eng._stacked_probe is probe, "a full re-stack instead of a slot update"
        updated += len(s["compacted"])
        kept = [int(st.slot_of[mi]) for mi in range(3) if mi not in s["compacted"]]
        for old, new in zip(before, (st.emb_cat, st.groups.hi, st.level_hi[-1])):
            w = min(old.shape[1], new.shape[1])
            assert torch.equal(old[kept, :w], new[kept, :w])
        assert_stacked_equal(st, ref._stacked_probe.stacked)
        assert int(st.n_paths[st.slot_of].sum()) == sum(m.index.n_paths for m in eng.models)
        assert st.nbytes() == st.padding_stats()["stacked_bytes"]
        loop = eng.match_many(qs, probe_impl="loop")
        assert loop == eng.match_many(qs) == ref.match_many(qs, probe_impl="loop")
        hand_off = eng.match_many(qs, join_impl="device")
        assert [sort_matches(m) for m in hand_off] == [sort_matches(m) for m in loop]
    assert updated


def test_deferred_compaction_equals_inline(graph):
    """``compaction="defer"`` queues the partitions; prepare → build →
    install gives the inline engine's index and lists; a snapshot that an
    update overtook is refused.  The queue and the installs follow the
    reference's."""
    fields = dict(probe_impl="stacked", index_kind="grouped", delta_compact_min=8,
                  delta_compact_frac=0.01)
    ref, (inline, deferred) = engines(graph, 2, **fields)
    rng = np.random.default_rng(5)
    ru, pu = rand_update(rng, graph, add=3, remove=3)
    s_in = inline.apply_updates(pu)
    s_def = deferred.apply_updates(pu, compaction="defer")
    want = ref.apply_updates(ru, compaction="defer")
    assert s_def == want and s_in["compacted"] and not s_def["compacted"]
    pending = deferred.pending_compactions()
    assert pending == ref.pending_compactions() and sorted(pending) == s_in["compacted"]
    qs = queries(graph)
    assert list(map(sorted, deferred.match_many(qs))) == list(map(sorted, inline.match_many(qs)))
    # a snapshot overtaken by an update is refused and stays pending
    stale = deferred.prepare_compaction(pending[0])
    ru2, pu2 = rand_update(rng, deferred.graph, add=2, remove=2)
    for e in (inline, deferred):
        e.apply_updates(pu2, compaction="defer" if e is deferred else "inline")
    ref.apply_updates(ru2, compaction="defer")
    assert not deferred.install_compaction(stale, deferred.build_compaction(stale))
    assert deferred.pending_compactions() == ref.pending_compactions()
    for mi in deferred.pending_compactions():
        snap, rsnap = deferred.prepare_compaction(mi), ref.prepare_compaction(mi)
        assert deferred.install_compaction(snap, deferred.build_compaction(snap))
        assert ref.install_compaction(rsnap, ref.build_compaction(rsnap))
        assert_index_equal(deferred.models[mi].index, ref.models[mi].index)
    assert deferred.pending_compactions() == []
    assert_delta_equal(deferred.delta, ref.delta)
    for join in ("numpy", "device"):
        assert deferred.match_many(qs, join_impl=join) == ref.match_many(qs, join_impl=join)
    assert list(map(sorted, deferred.match_many(qs))) == list(map(sorted, inline.match_many(qs)))


def test_epoch_fresh_equals_reference(graph):
    """``epoch_fresh``: None before an update; the touched vertices, the
    mutated partitions (deletion flags, inserted label hashes) and each
    partition's appended rows of a delta epoch as the reference's; a
    rebuild epoch carries no rows."""
    ref, (eng,) = engines(graph, quantize_index=True, delta_compact_min=10**9)
    assert eng.epoch_fresh() is None
    ru, pu = rand_update(np.random.default_rng(2), graph, add=3, remove=3, add_vertices=1)
    ref.apply_updates(ru)
    eng.apply_updates(pu)
    got, want = eng.epoch_fresh(), ref.epoch_fresh()
    assert (got["epoch"], got["strategy"]) == (want["epoch"], want["strategy"]) == (1, "delta")
    np.testing.assert_array_equal(got["touched"], want["touched"])
    assert sorted(got["mutated"]) == sorted(want["mutated"]) and got["mutated"]
    for mi, info in got["mutated"].items():
        assert info["deleted"] == want["mutated"][mi]["deleted"]
        np.testing.assert_array_equal(info["inserted_hashes"],
                                      want["mutated"][mi]["inserted_hashes"])
    assert sorted(got["fresh"]) == sorted(want["fresh"])
    for mi, fresh in got["fresh"].items():
        w = want["fresh"][mi]
        assert fresh.n_rows == w.n_rows > 0
        np.testing.assert_array_equal(fresh.paths.numpy(), w.paths)
        np.testing.assert_array_equal(fresh.emb_q.numpy(), w.emb_q)
        np.testing.assert_array_equal(fresh.label_hash.numpy(), w.label_hash)
    eng.apply_updates(pu, strategy="rebuild")
    assert eng.epoch_fresh() == {"epoch": 2, "strategy": "rebuild"}


def test_update_arguments_are_checked(graph):
    _, (eng,) = engines(graph)
    for kw, msg in [({"strategy": "x"}, "strategy"), ({"compaction": "x"}, "compaction")]:
        with pytest.raises(ValueError, match=msg):
            eng.apply_updates(PD.GraphUpdate(), **kw)
    with pytest.raises(ValueError, match="vocabulary"):
        eng.apply_updates(PD.GraphUpdate(add_vertex_labels=np.array([9], np.int32)))
    assert eng.apply_updates(PD.GraphUpdate())["mutated"] == []
