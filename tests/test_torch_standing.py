"""The port's standing queries (``serve/standing.py``,
``GnnPeEngine.match_incremental``) on the CPU, held against the JAX
package's on the same seeded update streams.

- at every epoch of a random stream (edge and vertex adds and removes,
  forced inline compaction) each subscription's accumulated set equals a
  from-scratch ``match_many``, across kinds × probes × joins;
- per epoch, each ``MatchDelta``'s added and retracted matches equal the
  reference's, and the registration's query operands equal its;
- the cheap and fallback paths: an untouched subscription pays no probe,
  a rebuild or an epoch gap takes one full refresh, a tombstoned match
  edge retracts the match, a background compaction install leaves the
  state exact, a deterministic failure quarantines;
- the serving tiers: ``MatchServer`` interleaves subscription ticks with
  query ticks; ``MatchService`` delivers deltas in epoch order with
  per-tenant caps (its from-scratch sets taken after ``stop``) and sheds
  a slow subscriber.
"""
import asyncio

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve.standing import StandingQueryRegistry as RefRegistry  # noqa: E402
from repro_torch.core import GnnPeConfig, GnnPeEngine, GraphUpdate, vf2_match  # noqa: E402
from repro_torch.graphs import from_edge_list  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AdmissionConfig,
    FaultSpec,
    FlakyEngine,
    MatchServeConfig,
    MatchServer,
    MatchService,
    ServiceConfig,
    StandingQueryRegistry,
    TenantQuota,
)
from repro_torch.serve import standing as standing_mod  # noqa: E402
from test_torch_delta import engines, port_graph, queries, rand_update  # noqa: E402

BOUND_S = 60.0  # every async test's own bound


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for the module: test files run in several processes
    at once, and each process's full thread pool would oversubscribe the
    cores (these files ran 3× slower in 3 processes with the default)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graph():
    from repro.graphs import erdos_renyi

    return erdos_renyi(150, avg_degree=3.5, n_labels=4, seed=5)


def port_engine(g, n: int = 1, **fields):
    """Port engines of ``engines``' config built by the port alone (the
    monotone encoder trains nothing): for tests that hold the port to
    itself, with no reference engine to build."""
    cfg = GnnPeConfig(**dict(dict(n_partitions=3, encoder="monotone", n_multi=1, block_size=32,
                                  group_size=4), **fields))
    engs = [GnnPeEngine(cfg, device="cpu").build(port_graph(g)) for _ in range(n)]
    return engs[0] if n == 1 else engs


def apply_delta(acc: set, delta) -> set:
    """A subscriber's accumulator: no re-add of a held match, no
    retraction of an unknown one."""
    added, retracted = set(delta.added), set(delta.retracted)
    assert not (added & acc), "delta re-added a match the subscriber already holds"
    assert retracted <= acc, "delta retracted a match the subscriber never had"
    return (acc - retracted) | added


def fields(d) -> tuple:
    """A MatchDelta of either package as plain values."""
    return (d.added, d.retracted, d.epoch, d.error)


def scratch(eng, q) -> set:
    return set(map(tuple, eng.match_many([q])[0]))


@pytest.mark.parametrize(
    "kind,impl,join",
    [
        ("path", "loop", "numpy"),
        ("grouped", "loop", "numpy"),
        ("path", "stacked", "numpy"),
        ("grouped", "stacked", "device"),
        ("path", "loop", "device"),
    ],
)
def test_standing_equals_from_scratch(graph, kind, impl, join):
    rng = np.random.default_rng(11)
    eng = port_engine(graph, index_kind=kind, probe_impl=impl, join_impl=join,
                      delta_compact_min=8)
    reg = StandingQueryRegistry(eng)
    qs = queries(graph)
    accs = {}
    for q in qs:
        sid, initial = reg.register(q)
        assert initial.epoch == 0 and not initial.retracted
        accs[sid] = apply_delta(set(), initial)
    compacted = 0
    for ep in range(6):
        _, upd = rand_update(rng, eng.graph, add_vertices=1 if ep % 2 else 0,
                             remove_vertices=1 if ep == 3 else 0)
        compacted += len(eng.apply_updates(upd)["compacted"])
        deltas = reg.on_epoch()
        for sid, q in zip(accs, qs):
            if sid in deltas:
                accs[sid] = apply_delta(accs[sid], deltas[sid])
            ref = scratch(eng, q)
            assert accs[sid] == ref, f"epoch {ep + 1}: accumulated != from-scratch"
            assert set(reg.matches(sid)) == ref
    assert compacted, "no compaction ran: the stream is too gentle"
    st = reg.stats()
    assert st["ticks"] == 6 and st["quarantined"] == 0 and st["advanced"] > 0
    for sid, q in zip(accs, qs):
        assert accs[sid] == set(vf2_match(eng.graph, q))


@pytest.mark.parametrize("kind,impl", [("path", "loop"), ("grouped", "stacked")])
def test_match_deltas_equal_reference(graph, kind, impl):
    """The same seeded stream through both registries: every epoch's
    deltas (added, retracted, epoch, the work rung) equal the reference's,
    and the registration's probe operands are the reference's (within
    1e-6 relative)."""
    ref, (eng,) = engines(graph, index_kind=kind, probe_impl=impl, delta_compact_min=8,
                          quantize_index=kind == "grouped")
    rng = np.random.default_rng(17)
    qs = queries(graph, n=4)
    regs = (StandingQueryRegistry(eng), RefRegistry(ref))
    for q in qs:
        (sid, got), (ref_sid, want) = (r.register(q) for r in regs)
        assert sid == ref_sid and fields(got) == fields(want)
    for sid in range(len(qs)):
        got, want = (r.subscription(sid).state for r in regs)
        assert got.plan_hashes == want.plan_hashes and sorted(got.qt) == sorted(want.qt)
        for key, ops in got.qt.items():
            # the port embeds every partition in one stacked GNN call, the
            # reference one partition at a time: an ulp apart at most
            for a, b in zip(ops[:3], want.qt[key][:3]):
                np.testing.assert_allclose(a.cpu().numpy(), b, rtol=1e-6, atol=0)
            assert ops[3] == want.qt[key][3]
    for ep in range(5):
        ru, pu = rand_update(rng, eng.graph, add=3, remove=2, add_vertices=ep % 2,
                             remove_vertices=1 if ep == 2 else 0)
        ref.apply_updates(ru)
        eng.apply_updates(pu)
        got, want = (r.on_epoch() for r in regs)
        assert {k: fields(d) for k, d in got.items()} == {
            k: fields(d) for k, d in want.items()}, f"epoch {ep + 1}"
        for sid in range(len(qs)):
            work = [r.subscription(sid).state.last_work for r in regs]
            assert work[0] == work[1]
            assert regs[0].matches(sid) == regs[1].matches(sid)
    assert regs[0].stats() == regs[1].stats()
    assert regs[0].stats()["advanced"] > 0  # the incremental rung ran


def test_standing_survives_background_compaction_install(graph):
    rng = np.random.default_rng(3)
    eng = port_engine(graph, delta_compact_min=8)
    reg = StandingQueryRegistry(eng)
    qs = queries(graph)
    accs = {}
    for q in qs:
        sid, initial = reg.register(q)
        accs[sid] = set(initial.added)
    for ep in range(4):
        eng.apply_updates(rand_update(rng, eng.graph)[1], compaction="defer")
        if ep == 1:  # install after the epoch, before the tick
            for mi in eng.pending_compactions():
                snap = eng.prepare_compaction(mi)
                eng.install_compaction(snap, GnnPeEngine.build_compaction(snap))
        deltas = reg.on_epoch()
        for sid, q in zip(accs, qs):
            if sid in deltas:
                accs[sid] = apply_delta(accs[sid], deltas[sid])
            assert accs[sid] == scratch(eng, q)
    assert eng.delta.n_compactions >= 1, "no compaction installed: the test is vacuous"


def test_full_refresh_on_rebuild_and_epoch_gap(graph):
    rng = np.random.default_rng(9)
    eng = port_engine(graph)
    reg = StandingQueryRegistry(eng)
    (q,) = queries(graph, n=1)
    sid, initial = reg.register(q)
    acc = set(initial.added)
    eng.apply_updates(rand_update(rng, eng.graph)[1], strategy="rebuild")
    deltas = reg.on_epoch()
    assert reg.subscription(sid).state.last_work == "full"
    if sid in deltas:
        acc = apply_delta(acc, deltas[sid])
    assert acc == scratch(eng, q)
    eng.apply_updates(rand_update(rng, eng.graph)[1])
    eng.apply_updates(rand_update(rng, eng.graph)[1])
    deltas = reg.on_epoch()
    assert reg.subscription(sid).state.last_work == "full"
    if sid in deltas:
        acc = apply_delta(acc, deltas[sid])
    assert acc == scratch(eng, q)
    assert reg.subscription(sid).n_refreshed == 2


def test_untouched_subscription_pays_nothing(monkeypatch):
    """An update far from a subscription's candidates (another component,
    another label alphabet) advances it with no probe and no join."""
    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4)]
    labels = np.array([0, 1, 0, 1, 2, 3, 2, 3], np.int32)
    from repro.graphs import from_edge_list as ref_from_edge_list

    g = ref_from_edge_list(8, edges, labels)
    eng = port_engine(g, n_partitions=2)
    reg = StandingQueryRegistry(eng)
    q = from_edge_list(4, [(0, 1), (1, 2), (2, 3), (3, 0)], np.array([0, 1, 0, 1], np.int32))
    sid, initial = reg.register(q)
    assert initial.added, "the query must match something for the test to bite"
    calls = []
    for name in ("probe_delta_multi", "match_from_candidates"):
        real = getattr(standing_mod, name)
        monkeypatch.setattr(standing_mod, name,
                            lambda *a, _real=real, _n=name, **k: calls.append(_n) or _real(*a, **k))
    eng.apply_updates(GraphUpdate(add_edges=np.array([[4, 6]]), remove_edges=np.array([[5, 6]])))
    assert eng.epoch_fresh()["fresh"], "the update appended no rows: the test is vacuous"
    deltas = reg.on_epoch()
    sub = reg.subscription(sid)
    assert sub.state.last_work == "skip" and sub.n_skipped == 1
    assert calls == [] and sid not in deltas and sub.state.epoch == eng.epoch
    assert set(reg.matches(sid)) == scratch(eng, q)


def test_retraction_on_tombstone(graph):
    eng = port_engine(graph)
    reg = StandingQueryRegistry(eng)
    (q,) = queries(graph, n=1)
    sid, initial = reg.register(q)
    assert initial.added
    victim = initial.added[0]
    qe = q.edge_array()
    u, v = int(victim[qe[0][0]]), int(victim[qe[0][1]])
    eng.apply_updates(GraphUpdate(remove_edges=np.array([[u, v]])))
    deltas = reg.on_epoch()
    assert sid in deltas and victim in set(deltas[sid].retracted)
    acc = apply_delta(set(initial.added), deltas[sid])
    ref = scratch(eng, q)
    assert acc == ref and victim not in ref
    assert ref == set(vf2_match(eng.graph, q))


def test_registry_quarantines_deterministic_failures(graph):
    eng = port_engine(graph)
    (q,) = queries(graph, n=1)
    rng = np.random.default_rng(0)
    flaky = FlakyEngine(eng, FaultSpec())
    reg = StandingQueryRegistry(flaky, max_failures=2)
    sid, _ = reg.register(q)
    flaky.spec = FaultSpec(transient_on=(2,))  # call 1 was the registration
    eng.apply_updates(rand_update(rng, eng.graph)[1])
    assert reg.on_epoch() == {} and reg.subscription(sid).failures == 1
    assert not reg.subscription(sid).quarantined and reg.stats()["transient_errors"] == 1
    flaky.spec = FaultSpec()
    reg.on_epoch()
    sub = reg.subscription(sid)
    assert sub.failures == 0 and sub.state.epoch == eng.epoch
    flaky.spec = FaultSpec(poison=lambda _q: True)
    eng.apply_updates(rand_update(rng, eng.graph)[1])
    assert reg.on_epoch() == {}  # failure 1 of 2: retried
    deltas = reg.on_epoch()  # failure 2 of 2: terminal
    sub = reg.subscription(sid)
    assert sub.quarantined and deltas[sid].error and "PoisonedQueryError" in deltas[sid].error
    assert reg.stats()["quarantined"] == 1
    flaky.spec = FaultSpec()
    assert reg.on_epoch() == {}


def test_match_server_interleaves_subscription_ticks(graph):
    rng = np.random.default_rng(21)
    eng = port_engine(graph)
    srv = MatchServer(eng, MatchServeConfig(max_batch=4, max_updates_per_tick=2))
    qs = queries(graph)
    sids = [srv.subscribe(q) for q in qs]
    for _ in range(3):
        srv.submit_update(rand_update(rng, eng.graph)[1])
        srv.submit_update(rand_update(rng, eng.graph)[1])
        rid = srv.submit(qs[0])
        srv.step()  # one coalesced epoch + subscription tick + query tick
        assert srv.finished[rid] == eng.match_many([qs[0]])[0]
        for sid, q in zip(sids, qs):
            acc = set()
            for d in srv.match_deltas[sid]:
                acc = apply_delta(acc, d)
            ref = scratch(eng, q)
            assert acc == ref and srv.standing_matches(sid) == sorted(ref)
    assert srv.registry.counters["ticks"] == 3 and srv.n_updates_applied == 6
    assert len(srv.update_s) == 3
    assert srv.unsubscribe(sids[0]) and not srv.unsubscribe(sids[0])


def test_service_subscriptions_async_delivery_and_caps(graph):
    """Per-tenant caps reject, deltas arrive on the handle's queue in
    epoch order, and the accumulated sets equal from-scratch sets taken
    after ``stop``, when no engine thread can still be working."""
    eng = port_engine(graph, delta_compact_min=8)
    qs = queries(graph)
    svc = MatchService(
        eng,
        ServiceConfig(max_batch=4, idle_tick_s=0.02, backoff_base_s=0.005, cache_fastpath=False),
        admission=AdmissionConfig(default_quota=TenantQuota(max_subscriptions=2)),
    )

    async def go():
        await svc.start()
        h0 = await svc.subscribe(qs[0], tenant="a")
        h1 = await svc.subscribe(qs[1], tenant="a")
        h_rej = await svc.subscribe(qs[2], tenant="a")
        h_b = await svc.subscribe(qs[2], tenant="b")
        assert h0.ok and h1.ok and h_b.ok
        assert h_rej.status == "rejected" and h_rej.reason == "tenant-subscriptions"
        rng = np.random.default_rng(5)
        for _ in range(3):
            svc.submit_update(rand_update(rng, eng.graph)[1])
            await svc.drain()
        assert await svc.unsubscribe(h1.sub_id)
        h_again = await svc.subscribe(qs[2], tenant="a")
        assert h_again.ok
        await svc.stop()
        accs = []
        for h in (h0, h_b, h_again):
            acc, epochs = set(), []
            while not h.deltas.empty():
                d = h.deltas.get_nowait()
                assert not d.error
                epochs.append(d.epoch)
                acc = apply_delta(acc, d)
            assert epochs == sorted(epochs)
            accs.append(acc)
        return accs

    accs = asyncio.run(asyncio.wait_for(go(), BOUND_S))
    for acc, q in zip(accs, (qs[0], qs[2], qs[2])):
        assert acc == scratch(eng, q)
    assert svc.counters["subs_rejected"] == 1 and svc.counters["subscribed"] == 4


def test_service_sheds_slow_subscriber(graph):
    eng = port_engine(graph)
    (q,) = queries(graph, n=1)
    qe = q.edge_array()
    m0 = sorted(map(tuple, eng.match_many([q])[0]))[0]
    u, v = int(m0[qe[0][0]]), int(m0[qe[0][1]])
    svc = MatchService(eng, ServiceConfig(max_batch=4, idle_tick_s=0.02, cache_fastpath=False,
                                          max_deltas_buffered=1))

    async def go():
        await svc.start()
        h = await svc.subscribe(q, tenant="slow")  # the initial delta fills the buffer
        svc.submit_update(GraphUpdate(remove_edges=np.array([[u, v]])))
        await svc.drain()
        for _ in range(200):  # the overflow verdict lands via call_soon_threadsafe
            if not h.ok:
                break
            await asyncio.sleep(0.01)
        subs = svc.admission.subscriptions("slow")
        await svc.stop()
        return h, subs

    h, subs = asyncio.run(asyncio.wait_for(go(), BOUND_S))
    assert h.status == "shed" and h.reason == "delta-queue-full"
    assert svc.counters["subs_shed"] == 1 and subs == 0


def test_resubscribe_pins_the_id_with_a_full_refresh(graph):
    rng = np.random.default_rng(31)
    eng = port_engine(graph)
    srv = MatchServer(eng)
    qs = queries(graph)
    sid = srv.subscribe(qs[0])
    assert srv.unsubscribe(sid)
    eng.apply_updates(rand_update(rng, eng.graph)[1])
    srv.resubscribe(sid, qs[0])
    (initial,) = srv.match_deltas[sid]
    assert set(initial.added) == scratch(eng, qs[0]) and initial.epoch == eng.epoch
    with pytest.raises(ValueError, match="already registered"):
        srv.resubscribe(sid, qs[1])
    assert srv.subscribe(qs[1]) == sid + 1  # fresh ids continue past a pinned one
    srv.submit_update(rand_update(rng, eng.graph)[1])
    srv.step()
    acc = set()
    for d in srv.match_deltas[sid]:
        acc = apply_delta(acc, d)
    assert acc == scratch(eng, qs[0])
