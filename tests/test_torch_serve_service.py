"""The port's serving tier (``serve/match_server.py``, ``service.py``,
``admission.py``, ``faults.py``) on the CPU, held against the JAX
package's where the answer is deterministic.

- admission: the token bucket and backlog decisions equal the reference's;
- ``MatchServer``: bounded queues raise ``QueueFull``, ``wait_for_work``
  parks instead of spinning, cost-ranked ticks, durability reaches a WAL
  and ``scrub`` returns a report;
- the engine's serving methods: ``match_many_isolated`` quarantines the
  reference's indices with the reference's lists, and fails a transient
  batch whole; ``plan_cost`` equals the reference's, relabeled-isomorphic
  copies included; ``cache_peek`` gives the reference's hits;
- ``MatchService``: answers equal the engine's (and the reference's); the
  deadline schedule serves in the reference's order; transient faults
  retry with backoff, budgets exhaust, a hung tick times out, a poisoned
  query is quarantined, and under random faults every ok answer is
  byte-identical to the fault-free run; quotas, backlogs, global sheds,
  priority evictions and deadlines; the cache fast path; background
  compaction against inline, a stale install refused;
- a kernel that does not build or launch, or a CUDA error, planted in the
  engine's verdict, is re-raised by the isolation, the tick, the registry
  and the service, never quarantined or retried.

No pytest-asyncio here: each async test runs ``asyncio.run`` under an
``asyncio.wait_for`` bound of its own.
"""
import asyncio
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve import faults as ref_faults  # noqa: E402
from repro.serve import service as ref_service  # noqa: E402
from repro.serve.admission import AdmissionConfig as RefAdmissionConfig  # noqa: E402
from repro.serve.admission import AdmissionController as RefAdmissionController  # noqa: E402
from repro.serve.admission import TenantQuota as RefTenantQuota  # noqa: E402
from repro_torch.core import GnnPeEngine  # noqa: E402
from repro_torch.core import index as index_mod  # noqa: E402
from repro_torch.device import is_device_fault  # noqa: E402
from repro_torch.kernels.build import KernelBuildError, KernelLaunchError  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AdmissionConfig,
    AdmissionController,
    FaultSpec,
    FlakyEngine,
    MatchServeConfig,
    MatchServer,
    MatchService,
    PoisonedQueryError,
    QueueFull,
    ServiceConfig,
    StandingQueryRegistry,
    TenantQuota,
)
from test_torch_cache import isomorphic_copy  # noqa: E402
from test_torch_delta import engines, rand_update  # noqa: E402
from test_torch_standing import one_torch_thread, port_engine  # noqa: E402,F401

BOUND_S = 60.0  # every async test's own bound


@pytest.fixture(scope="module")
def graph():
    from repro.graphs import erdos_renyi

    return erdos_renyi(150, avg_degree=3.5, n_labels=4, seed=5)


@pytest.fixture(scope="module")
def pair(graph):
    """The reference engine and its port (no cache; tests that update or
    fault build their own, or wrap these without mutating them)."""
    ref, (eng,) = engines(graph)
    return ref, eng


def make_queries(g, n=8, size=4, seed0=50):
    from repro.graphs import random_connected_query

    out, s = [], seed0
    while len(out) < n:
        try:
            out.append(random_connected_query(g, size + len(out) % 3, seed=s))
        except RuntimeError:
            pass
        s += 1
    return out


def svc_cfg(cls=ServiceConfig, **kw):
    base = dict(max_batch=4, idle_tick_s=0.02, backoff_base_s=0.005, cache_fastpath=False)
    base.update(kw)
    return cls(**base)


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, BOUND_S))


async def serve_all(svc, queries, **submit_kw):
    await svc.start()
    futs = [svc.submit(q, **submit_kw)[1] for q in queries]
    resps = await asyncio.gather(*futs)
    await svc.stop()
    return resps


# ------------------------------------------------------ admission unit ----


def test_token_bucket_and_backlog_equal_reference():
    got = []
    for ctl_cls, cfg_cls, quota in (
        (AdmissionController, AdmissionConfig, TenantQuota),
        (RefAdmissionController, RefAdmissionConfig, RefTenantQuota),
    ):
        t = [0.0]
        ctl = ctl_cls(
            cfg_cls(quotas={"metered": quota(rate=2.0, burst=2.0, max_backlog=10),
                            "narrow": quota(max_backlog=2, max_subscriptions=1)}),
            clock=lambda: t[0],
        )
        out = [ctl.admit("metered") for _ in range(3)]
        t[0] = 0.5  # refill at 2 tokens/s: half a second buys exactly one more
        out += [ctl.admit("metered") for _ in range(2)]
        out += [ctl.admit("narrow") for _ in range(3)]
        ctl.release("narrow")
        out += [ctl.admit("narrow"), ctl.admit_subscription("narrow"),
                ctl.admit_subscription("narrow")]
        ctl.release_subscription("narrow")
        out += [ctl.admit("other") for _ in range(10)]
        got.append((out, ctl.stats(), ctl.backlog("metered"), ctl.subscriptions("narrow")))
    assert got[0] == got[1]
    out, st, backlog, subs = got[0]
    assert out[:5] == [(True, ""), (True, ""), (False, "tenant-quota"), (True, ""),
                       (False, "tenant-quota")]
    assert out[7] == (False, "tenant-backlog") and out[10] == (False, "tenant-subscriptions")
    assert st["metered"]["rejected"] == 2 and st["other"]["admitted"] == 10
    assert backlog == 3 and subs == 0


# -------------------------------------------------------- MatchServer ----


def test_match_server_bounded_queues_raise_queue_full(graph, pair):
    _, eng = pair
    srv = MatchServer(eng, MatchServeConfig(max_batch=2, max_queue=3, max_update_queue=2))
    qs = make_queries(graph, n=4)
    for q in qs[:3]:
        srv.submit(q)
    with pytest.raises(QueueFull):
        srv.submit(qs[3])
    rng = np.random.default_rng(3)
    for _ in range(2):
        srv.submit_update(rand_update(rng, graph)[1])
    with pytest.raises(QueueFull):
        srv.submit_update(rand_update(rng, graph)[1])
    srv.update_queue.clear()  # the shared engine stays un-updated
    out = srv.run_until_drained()
    assert [out[i] for i in range(3)] == eng.match_many(qs[:3])
    srv.submit(qs[3])
    assert len(srv.queue) == 1


def test_match_server_wait_for_work_idle_backoff(graph, pair):
    _, eng = pair
    srv = MatchServer(eng)
    assert srv.wait_for_work(timeout=0.01) is False  # times out instead of spinning
    got = []
    waiter = threading.Thread(target=lambda: got.append(srv.wait_for_work(timeout=10.0)))
    waiter.start()
    srv.submit(make_queries(graph, n=1)[0])
    waiter.join(timeout=20.0)
    assert got == [True]
    assert srv.wait_for_work(timeout=0.0) is True


def test_match_server_cost_ticks_and_reference_lists(graph, pair):
    """Cost-ranked ticks serve every request exactly as ``match_many``
    does (and as the reference's), cheapest plans first within a tick."""
    ref, eng = pair
    qs = make_queries(graph, n=10)
    srv = MatchServer(eng, MatchServeConfig(max_batch=4, schedule="cost"))
    rids = [srv.submit(q) for q in qs]
    out = srv.run_until_drained()
    want = ref.match_many(qs)
    assert [out[r] for r in rids] == want == eng.match_many(qs)
    assert [t["n_queries"] for t in srv.tick_stats] == [4, 4, 2]
    costs = [eng.plan_cost(q) for q in qs]
    first = sorted(range(10), key=lambda i: (costs[i], i))[:4]
    oldest = 0
    if oldest not in first:
        first[-1] = oldest
    assert srv.tick_stats[0]["min_cost"] == min(costs[i] for i in first)
    assert srv.tick_stats[0]["max_cost"] == max(costs[i] for i in first)


def test_durability_and_scrub_name_their_roadmap_item(graph, pair, tmp_path):
    """The server's and the service's ``durability=`` reach a write-ahead
    log (a genesis snapshot, then one epoch record an update tick, logged
    before it is applied), and ``scrub()`` returns the audit's report."""
    from repro_torch.durability import Durability, DurabilityConfig

    _, eng = pair
    report = MatchServer(eng).scrub()
    assert report["ok"] and report["partitions_checked"] == [0, 1, 2]
    assert report["epoch"] == eng.epoch and not report["violations"]
    _, (mine,) = engines(graph)
    cfg = DurabilityConfig(str(tmp_path / "server"), snapshot_every=0)
    srv = MatchServer(mine, MatchServeConfig(durability=cfg))
    assert srv.durability.snapshots.latest_epoch() == 0
    _, upd = rand_update(np.random.default_rng(3), graph)
    srv.submit_update(upd)
    srv.apply_update_tick()
    recs = srv.durability.wal.records()
    assert [(r.type, r.epoch) for r in recs] == [("epoch", 1)] and mine.epoch == 1
    dur = Durability(DurabilityConfig(str(tmp_path / "service"), snapshot_every=0))
    svc = MatchService(mine, svc_cfg(durability=dur))
    assert svc.server.durability is dur and dur.snapshots.latest_epoch() == 1


# ----------------------------------------------------- isolation (bisect) ----


def test_match_many_isolated_quarantines_the_reference_indices(graph, pair):
    ref, eng = pair
    qs = make_queries(graph, n=6)
    bad = {2, 5}
    got = []
    for e, flaky_cls, spec_cls in ((eng, FlakyEngine, FaultSpec),
                                   (ref, ref_faults.FlakyEngine, ref_faults.FaultSpec)):
        flaky = flaky_cls(e, spec_cls(poison=lambda q: any(q is qs[i] for i in bad)))
        got.append((flaky.match_many_isolated(qs), flaky.n_calls))
    (port_res, port_calls), (ref_res, ref_calls) = got
    assert port_calls == ref_calls
    assert [ok for ok, _ in port_res] == [ok for ok, _ in ref_res] == [i not in bad for i in range(6)]
    want = eng.match_many(qs)
    for i, ((ok, val), (_, rval)) in enumerate(zip(port_res, ref_res)):
        if ok:
            assert val == rval == want[i]
        else:
            assert isinstance(val, PoisonedQueryError) and type(rval).__name__ == "PoisonedQueryError"


def test_match_many_isolated_fails_whole_batch_on_transient(graph, pair):
    _, eng = pair
    qs = make_queries(graph, n=4)
    flaky = FlakyEngine(eng, FaultSpec(p_transient=1.0))
    results = flaky.match_many_isolated(qs)
    assert len(results) == len(qs)
    assert all(not ok and getattr(val, "transient", False) for ok, val in results)
    assert flaky.n_calls == 1  # no bisection calls burned


def test_plan_cost_equals_reference_and_isomorphic_copies(graph, pair):
    ref, eng = pair
    qs = make_queries(graph, n=8)
    isos = [isomorphic_copy(q, 7 + i) for i, q in enumerate(qs)]
    got = [eng.plan_cost(q) for q in qs + isos]
    assert got == [ref.plan_cost(q) for q in qs + isos]
    assert got[:8] == got[8:]
    assert all(isinstance(c, float) for c in got)


def test_cache_peek_gives_the_reference_hits(graph):
    ref, (eng,) = engines(graph, cache=True)
    qs = make_queries(graph, n=5)
    for e in (ref, eng):
        e.match_many(qs[:3])
    asks = qs + [isomorphic_copy(qs[0], 3), isomorphic_copy(qs[4], 4)]
    got = [eng.cache_peek(q) for q in asks]
    want = [ref.cache_peek(q) for q in asks]
    assert got == want
    assert [g is not None for g in got] == [True, True, True, False, False, True, False]
    # a peek counts its hits and no misses, as the reference's does
    assert eng._result_cache.stats.as_dict() == ref._result_cache.stats.as_dict()
    assert eng._result_cache.stats.hits == 4 and eng._result_cache.stats.misses == 3
    assert got[5] == eng.match_many([asks[5]])[0]
    plain = port_engine(graph)
    assert plain.cache_peek(qs[0]) is None


# ------------------------------------------------------- service: happy ----


def test_service_plain_run_matches_engine(graph, pair):
    ref, eng = pair
    qs = make_queries(graph, n=10)
    want = eng.match_many(qs)
    assert want == ref.match_many(qs)
    svc = MatchService(eng, svc_cfg())
    resps = run(serve_all(svc, qs))
    assert all(r.ok for r in resps)
    assert [r.matches for r in resps] == want
    assert svc.counters["ok"] == 10 and svc.counters["submitted"] == 10
    assert all(t["n_queries"] <= 4 for t in svc.tick_stats())
    assert sum(t["n_queries"] for t in svc.tick_stats()) == 10


def test_deadline_schedule_serves_in_the_reference_order(graph, pair):
    """Lax and tight deadlines, cost × slack ranks: the port resolves the
    requests in the reference's order, and the tight ones in time."""
    ref, eng = pair
    qs = make_queries(graph, n=6)

    async def order(svc):
        done = []
        await svc.start()
        futs = [svc.submit(q, deadline_s=30.0)[1] for q in qs[:4]]
        futs += [svc.submit(q, deadline_s=2.0)[1] for q in qs[4:]]
        for i, f in enumerate(futs):
            f.add_done_callback(lambda _f, i=i: done.append(i))
        resps = await asyncio.gather(*futs)
        await svc.stop()
        return done, resps

    got, resps = run(order(MatchService(eng, svc_cfg(max_batch=2, schedule="deadline"))))
    want, ref_resps = run(order(ref_service.MatchService(
        ref, svc_cfg(ref_service.ServiceConfig, max_batch=2, schedule="deadline"))))
    assert got == want
    assert sorted(got) == list(range(6))
    assert all(r.ok for r in resps) and all(r.latency_s < 2.0 for r in resps[4:])
    assert [r.matches for r in resps] == [r.matches for r in ref_resps]


# ---------------------------------------------- faults: retry + backoff ----


def test_transient_fault_is_retried_with_backoff(graph, pair):
    _, eng = pair
    q = make_queries(graph, n=1)[0]
    want = eng.match_many([q])[0]
    flaky = FlakyEngine(eng, FaultSpec(transient_on=(1,)))
    svc = MatchService(flaky, svc_cfg())
    (r,) = run(serve_all(svc, [q]))
    assert r.ok and r.attempts == 1 and r.matches == want
    assert svc.counters["retries"] == 1
    assert flaky.n_transient == 1 and flaky.n_calls >= 2


def test_retry_budget_exhausts_with_structured_reason(graph, pair):
    _, eng = pair
    q = make_queries(graph, n=1)[0]
    flaky = FlakyEngine(eng, FaultSpec(p_transient=1.0))
    svc = MatchService(flaky, svc_cfg(max_retries=2))
    (r,) = run(serve_all(svc, [q]))
    assert r.status == "retry-exhausted" and r.attempts == 3 and "transient" in r.reason
    assert svc.counters["retry-exhausted"] == 1 and svc.counters["retries"] == 2


def test_hung_tick_times_out_and_recovers(graph, pair):
    _, eng = pair
    q = make_queries(graph, n=1)[0]
    want = eng.match_many([q])[0]
    flaky = FlakyEngine(eng, FaultSpec(hang_on=(1,), hang_s=0.25))
    svc = MatchService(flaky, svc_cfg(attempt_timeout_s=0.08, backoff_base_s=0.3))
    (r,) = run(serve_all(svc, [q]))
    assert r.ok and r.attempts == 1 and r.matches == want
    assert svc.counters["attempt_timeouts"] == 1


def test_poisoned_query_is_quarantined_not_retried(graph, pair):
    _, eng = pair
    qs = make_queries(graph, n=6)
    want = eng.match_many(qs[:5])
    flaky = FlakyEngine(eng, FaultSpec(poison=lambda q: q is qs[5]))
    svc = MatchService(flaky, svc_cfg(max_batch=6))
    resps = run(serve_all(svc, qs))
    assert [r.matches for r in resps[:5]] == want
    bad = resps[5]
    assert bad.status == "error" and bad.reason.startswith("quarantined:")
    assert "PoisonedQueryError" in bad.reason and bad.attempts == 0
    assert svc.counters["error"] == 1 and svc.counters["ok"] == 5


def test_faulted_run_loses_only_faulted_requests_byte_identical(graph, pair):
    """Random transient faults and one poisoned query: only the poisoned
    request is lost; every other answer is byte-identical to the
    fault-free run's (and to the reference engine's)."""
    from repro.graphs import random_connected_query

    ref, eng = pair
    qs = make_queries(graph, n=12)
    want = eng.match_many(qs)
    assert want == ref.match_many(qs)
    poisoned = random_connected_query(graph, 4, seed=999)
    flaky = FlakyEngine(eng, FaultSpec(p_transient=0.35, seed=11, poison=lambda q: q is poisoned))
    svc = MatchService(flaky, svc_cfg(max_retries=8, backoff_max_s=0.02))

    async def go():
        await svc.start()
        futs = [svc.submit(q)[1] for q in qs]
        pf = svc.submit(poisoned)[1]
        resps = await asyncio.gather(*futs)
        presp = await pf
        await svc.stop()
        return resps, presp

    resps, presp = run(go())
    assert presp.status == "error" and "quarantined" in presp.reason
    for r, w in zip(resps, want):
        assert r.ok, (r.status, r.reason)
        assert repr(r.matches) == repr(w)
    assert flaky.n_transient >= 1


# ----------------------------------------------- admission + shedding ----


def test_tenant_quota_rejects_before_queueing(graph, pair):
    _, eng = pair
    qs = make_queries(graph, n=4)
    svc = MatchService(eng, svc_cfg(),
                       AdmissionConfig(quotas={"small": TenantQuota(rate=0.0, burst=2.0)}))

    async def go():
        await svc.start()
        futs = [svc.submit(q, tenant="small")[1] for q in qs[:3]]
        other = svc.submit(qs[3], tenant="big")[1]
        rs = await asyncio.gather(*futs, other)
        await svc.stop()
        return rs

    r0, r1, r2, r_other = run(go())
    assert r0.ok and r1.ok and r_other.ok
    assert r2.status == "rejected" and r2.reason == "tenant-quota"
    assert svc.admission.stats()["small"]["rejected"] == 1


def test_tenant_backlog_bounds_unfinished_pileup(graph, pair):
    _, eng = pair
    qs = make_queries(graph, n=4)
    flaky = FlakyEngine(eng, FaultSpec(p_transient=1.0))
    svc = MatchService(flaky, svc_cfg(max_retries=3, backoff_base_s=0.05, backoff_max_s=0.05),
                       AdmissionConfig(default_quota=TenantQuota(max_backlog=3)))

    async def go():
        await svc.start()
        futs = [svc.submit(q)[1] for q in qs[:3]]
        r_late = await svc.submit(qs[3])[1]
        rs = await asyncio.gather(*futs)
        await svc.stop()
        return rs, r_late

    rs, r_late = run(go())
    assert r_late.status == "rejected" and r_late.reason == "tenant-backlog"
    assert all(r.status == "retry-exhausted" for r in rs)
    assert svc.admission.backlog("default") == 0


def test_global_queue_full_sheds_new_requests(graph, pair):
    _, eng = pair
    qs = make_queries(graph, n=5)
    svc = MatchService(eng, svc_cfg(max_queue=3))
    rs = run(serve_all(svc, qs))
    assert [r.status for r in rs] == ["ok"] * 3 + ["shed"] * 2
    assert all(r.reason == "queue-full" for r in rs[3:])
    assert svc.counters["shed"] == 2 and svc.admission.backlog("default") == 0


def test_drop_lowest_priority_evicts_for_higher_priority(graph, pair):
    _, eng = pair
    qs = make_queries(graph, n=4)
    svc = MatchService(eng, svc_cfg(max_queue=2, shed_policy="drop-lowest-priority"))

    async def go():
        await svc.start()
        low = [svc.submit(q, priority=5)[1] for q in qs[:2]]
        hi = svc.submit(qs[2], priority=0)[1]
        lo2 = svc.submit(qs[3], priority=9)[1]
        rs = await asyncio.gather(*low, hi, lo2)
        await svc.stop()
        return rs

    l0, l1, hi, lo2 = run(go())
    assert hi.ok and sorted([l0.status, l1.status]) == ["ok", "shed"]
    evicted = l0 if l0.status == "shed" else l1
    assert evicted.reason == "evicted-by-higher-priority"
    assert lo2.status == "shed" and lo2.reason == "queue-full"
    assert svc.counters["evictions"] == 1


def test_expired_deadline_is_shed_before_burning_a_tick(graph, pair):
    _, eng = pair
    qs = make_queries(graph, n=2)
    svc = MatchService(eng, svc_cfg())

    async def go():
        await svc.start()
        dead = svc.submit(qs[0], deadline_s=-0.001)[1]
        live = svc.submit(qs[1], deadline_s=30.0)[1]
        rs = await asyncio.gather(dead, live)
        await svc.stop()
        return rs

    r_dead, r_live = run(go())
    assert r_dead.status == "expired" and "deadline" in r_dead.reason
    assert r_live.ok
    assert sum(t["n_queries"] for t in svc.tick_stats()) == 1


def test_deadline_before_retry_expires_instead_of_retrying(graph, pair):
    _, eng = pair
    q = make_queries(graph, n=1)[0]
    flaky = FlakyEngine(eng, FaultSpec(p_transient=1.0))
    svc = MatchService(flaky, svc_cfg(max_retries=10, backoff_base_s=0.5))
    (r,) = run(serve_all(svc, [q], deadline_s=0.2))
    assert r.status == "expired" and "deadline-before-retry" in r.reason and r.attempts == 1


def test_cache_fastpath_serves_hits_even_when_queue_full(graph):
    eng = port_engine(graph, cache=True)
    qs = make_queries(graph, n=3)
    warm = eng.match_many([qs[0]])[0]
    flaky = FlakyEngine(eng, FaultSpec(p_transient=1.0))
    svc = MatchService(flaky, svc_cfg(cache_fastpath=True, max_queue=1, max_retries=0))

    async def go():
        await svc.start()
        filler = svc.submit(qs[1])[1]
        hit = svc.submit(qs[0])[1]
        miss = svc.submit(qs[2])[1]
        rs = await asyncio.gather(filler, hit, miss)
        await svc.stop()
        return rs

    r_fill, r_hit, r_miss = run(go())
    assert r_hit.ok and r_hit.from_cache and r_hit.matches == warm
    assert r_miss.status == "shed" and r_fill.status == "retry-exhausted"
    assert svc.counters["cache_fastpath"] == 1


# --------------------------------------- updates + background compaction ----


def test_service_updates_with_background_compaction_match_inline(graph):
    """The service's deferred compaction (snapshot → build → install off
    the tick) answers exactly, and once the installs land as inline
    compaction does, list for list; ``drain`` returns only once they are
    in."""
    eng_bg, eng_in = port_engine(graph, n=2, delta_compact_frac=0.01, delta_compact_min=4)
    rng = np.random.default_rng(3)
    updates = [rand_update(rng, graph)[1] for _ in range(6)]
    qs = make_queries(graph, n=4)
    srv = MatchServer(eng_in, MatchServeConfig(max_updates_per_tick=6))
    for u in updates:
        srv.submit_update(u)
    srv.run_until_drained()
    want = eng_in.match_many(qs)
    svc = MatchService(eng_bg, svc_cfg(background_compaction=True, idle_tick_s=0.01))

    async def go():
        await svc.start()
        for u in updates:
            svc.submit_update(u)
        await svc.drain()
        pending = eng_bg.pending_compactions()
        rs = await asyncio.gather(*[svc.submit(q)[1] for q in qs])
        await svc.stop()
        return rs, pending

    resps, pending_after_drain = run(go())
    assert pending_after_drain == []
    for r, w in zip(resps, want):
        assert r.ok and sorted(r.matches) == sorted(w)
    assert svc.counters["compactions_installed"] >= 1
    assert not eng_bg.pending_compactions()
    assert eng_bg.match_many(qs) == want


def test_stale_compaction_install_is_discarded_on_race(graph):
    eng, eng_ref = port_engine(graph, n=2, delta_compact_frac=0.01, delta_compact_min=4)
    rng = np.random.default_rng(3)
    updates = [rand_update(rng, graph)[1] for _ in range(4)]
    eng.apply_updates(updates[:2], compaction="defer")
    pending = eng.pending_compactions()
    assert pending
    mi = pending[0]
    snap = eng.prepare_compaction(mi)
    new_index = GnnPeEngine.build_compaction(snap)
    eng.apply_updates(updates[2:], compaction="defer")
    if snap.part.version == snap.version:
        snap.part.version += 1
    assert eng.install_compaction(snap, new_index) is False
    assert mi in eng.pending_compactions()
    qs = make_queries(graph, n=3)
    eng_ref.apply_updates(updates, compaction="inline")
    want = eng_ref.match_many(qs)
    snap2 = eng.prepare_compaction(mi)
    assert eng.install_compaction(snap2, GnnPeEngine.build_compaction(snap2))
    assert [sorted(m) for m in eng.match_many(qs)] == [sorted(w) for w in want]


def test_bounded_update_queue_backpressure_through_service(graph):
    eng = port_engine(graph)
    svc = MatchService(eng, svc_cfg(max_update_queue=2))
    rng = np.random.default_rng(1)

    async def go():
        svc.submit_update(rand_update(rng, graph)[1])
        svc.submit_update(rand_update(rng, graph)[1])
        with pytest.raises(QueueFull):
            svc.submit_update(rand_update(rng, graph)[1])
        await svc.start()
        await svc.drain()
        await svc.stop()

    run(go())
    assert eng.delta_stats()["epoch"] >= 1


# ----------------------------------------- kernel and device faults ----


PLANTED = [
    KernelBuildError("nvcc failed (1): dominance_scan.cu"),
    KernelLaunchError("dominance_scan_pairs kernel launch failed: CUDA error 700"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
]


@pytest.fixture
def planted(monkeypatch, request):
    """The engine's fused verdict (the kernel entry K1's wrapper) raising
    ``request.param``."""
    exc = request.param

    def broken(*a, **k):
        raise exc

    def plant():
        monkeypatch.setattr(index_mod, "dominance_scan_pairs_indexed", broken)

    return exc, plant


@pytest.mark.parametrize("planted", PLANTED, indirect=True, ids=["build", "launch", "cuda"])
def test_device_fault_is_reraised_not_quarantined_or_retried(graph, planted):
    """A kernel build, launch or CUDA error inside a tick propagates: the
    isolation re-raises it without bisecting, the server's tick and the
    registry's subscription tick raise it, and the service fails the
    request's future with it and raises it from ``stop`` — no retry, no
    error status."""
    exc, plant = planted
    assert is_device_fault(exc)
    assert not is_device_fault(RuntimeError("shape mismatch")) and not is_device_fault(
        PoisonedQueryError("x"))
    eng = port_engine(graph)
    qs = make_queries(graph, n=4)
    reg = StandingQueryRegistry(eng)
    reg.register(qs[0])
    plant()
    flaky = FlakyEngine(eng, FaultSpec())
    with pytest.raises(type(exc)):
        flaky.match_many_isolated(qs)
    assert flaky.n_calls == 1  # no bisection
    with pytest.raises(type(exc)):
        MatchServer(eng).execute_batch(qs, isolate=True)
    eng.apply_updates(rand_update(np.random.default_rng(0), graph, add=3, remove=3)[1])
    with pytest.raises(type(exc)):
        reg.on_epoch()
    assert not reg.subscription(0).quarantined
    svc = MatchService(flaky, svc_cfg(max_retries=5))
    outcome = {}

    async def go():
        await svc.start()
        fut = svc.submit(qs[1])[1]
        try:
            await fut
        except type(exc) as e:
            outcome["future"] = e
        try:
            await svc.stop()
        except type(exc) as e:
            outcome["stop"] = e

    run(go())
    assert outcome["future"] is exc and outcome["stop"] is exc
    assert svc.counters["retries"] == 0 and svc.counters["error"] == 0
    assert svc.counters["ok"] == 0


def test_hot_vertex_coalescing_pulls_only_commuting_updates(graph):
    """``coalesce_hot`` pulls a queued update that touches a vertex the
    tick re-embeds and no skipped update's vertex, stops at a
    vertex-appending update, and the epochs it saves leave the answers
    the sets an uncoalesced server gives."""
    from repro_torch.core import GraphUpdate

    eng_c, eng_p = port_engine(graph, n=2)
    e = graph.edge_array()
    hot = int(e[0, 0])
    others = e[~np.isin(e, [hot]).any(axis=1)]
    ups = [
        GraphUpdate(remove_edges=e[:1]),                        # the tick's own
        GraphUpdate(remove_edges=others[:1]),                   # skipped: not hot
        GraphUpdate(add_edges=np.array([[hot, int(others[5, 1])]])),  # hot: pulled
        GraphUpdate(add_vertex_labels=np.array([1], np.int32)),  # appends: the scan stops
        GraphUpdate(add_edges=np.array([[hot, int(others[9, 0])]])),  # behind it: kept
    ]
    qs = make_queries(graph, n=4)
    servers = [MatchServer(eng_c, MatchServeConfig(max_updates_per_tick=1, coalesce_hot=True)),
               MatchServer(eng_p, MatchServeConfig(max_updates_per_tick=1))]
    for srv in servers:
        for u in ups:
            srv.submit_update(u)
    assert servers[0].apply_update_tick() == 2 and servers[0].coalesced_pulls == 1
    assert len(servers[0].update_queue) == 3
    for srv in servers:
        srv.run_until_drained()
    assert servers[0].n_updates_applied == servers[1].n_updates_applied == 5
    assert len(servers[0].update_s) == 4 and len(servers[1].update_s) == 5
    for a, b in zip(eng_c.match_many(qs), eng_p.match_many(qs)):
        assert sorted(a) == sorted(b)
