"""The port's observability layer (``repro_torch.obs``) and the engine's
instrumentation, held against the JAX package's on the CPU.

- registry: labeled children, histogram buckets, idempotent and
  type-checked registration, exact sums under 8 threads, the kill switch;
  the port's and the reference's registries fed the same operations give
  byte-equal Prometheus text and equal snapshots;
- tracing: deterministic sampling (the same traces sampled as the
  reference's); a traced ``match_many`` whose five funnel rungs and
  per-partition row attributions equal the reference's traced funnel on
  the same graph and queries, for the path and grouped kinds under both
  probes and for the stacked probe's hand-off to the device join, also
  under pending updates; its stage tree and stage sums;
- export: the Prometheus round trip, the JSON snapshot, ``/metrics`` on
  loopback and the event log;
- the engine, server, service, standing and admission metrics carry the
  reference's names, types, help and labels;
- a faulted ``MatchService`` run's per-status counters sum to what was
  submitted.
"""
import asyncio
import json
import threading
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.obs as ref_obs  # noqa: E402
from repro.obs import export as ref_export  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import index as port_index  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    EVENTS,
    REGISTRY,
    TRACER,
    EventLog,
    MetricsHTTPServer,
    MetricsRegistry,
    disable,
    enable,
    parse_prometheus,
    to_prometheus,
    trace_query,
    write_json_snapshot,
)
from repro_torch.serve import FaultSpec, FlakyEngine, MatchService, ServiceConfig  # noqa: E402
from test_torch_delta import engines, queries, rand_update  # noqa: E402
from test_torch_standing import one_torch_thread  # noqa: E402,F401

STAGES = ("cache_lookup", "embed", "plan", "probe", "assemble", "join", "cache_store")


@pytest.fixture(scope="module")
def graph():
    from repro.graphs import erdos_renyi

    return erdos_renyi(150, avg_degree=3.5, n_labels=4, seed=5)


@pytest.fixture(scope="module")
def grouped_pair(graph):
    """A grouped reference engine and its port (a grouped engine runs both kinds)."""
    ref, (eng,) = engines(graph, index_kind="grouped")
    return ref, eng


# ---------------------------------------------------------- registry unit --


def feed(reg) -> None:
    """One sequence of registry operations, fed to either package's registry."""
    c = reg.counter("t_requests_total", "requests", labels=("status",))
    c.labels(status="ok").inc()
    c.labels(status="ok").inc(2)
    c.labels(status='we"ird\\').inc(0.5)
    reg.counter("t_ticks_total", "ticks").inc(5)
    g = reg.gauge("t_depth", "queue depth", labels=("queue",))
    g.labels(queue="query").set(7)
    g.labels(queue="update").set(3)
    h = reg.histogram("t_lat_seconds", "latency")
    for v in (5e-5, 0.003, 0.2, 7.0, 500.0):
        h.observe(v)
    hb = reg.histogram("t_batch", "batch", labels=("kind",), buckets=(1, 2, 4, 8))
    for v in (1, 3, 3, 9):
        hb.labels(kind="q").observe(v)


def test_registries_fed_alike_export_byte_equal():
    port, ref = MetricsRegistry(), ref_obs.MetricsRegistry()
    feed(port)
    feed(ref)
    assert port.snapshot() == ref.snapshot()
    text = to_prometheus(port.snapshot())
    assert text == ref_export.to_prometheus(ref.snapshot())
    assert parse_prometheus(text) == ref_export.parse_prometheus(text)
    assert obs.metrics.DEFAULT_LATENCY_BUCKETS == ref_obs.metrics.DEFAULT_LATENCY_BUCKETS


def test_counter_labels_and_bare():
    reg = MetricsRegistry()
    c = reg.counter("t_requests_total", "requests", labels=("status",))
    c.labels(status="ok").inc()
    c.labels(status="ok").inc(2)
    c.labels(status="err").inc()
    vals = {tuple(v["labels"].items()): v["value"] for v in c.snapshot()["values"]}
    assert vals[(("status", "ok"),)] == 3 and vals[(("status", "err"),)] == 1
    assert c.get(status="ok") == 3
    with pytest.raises(ValueError):
        c.inc()  # a labeled metric refuses bare mutation
    bare = reg.counter("t_ticks_total", "ticks")
    bare.inc(5)
    with pytest.raises(ValueError):
        bare.labels(status="ok")
    assert bare.get() == 5


def test_registry_idempotent_and_type_checked():
    reg = MetricsRegistry()
    a = reg.counter("t_dup_total", "x")
    assert reg.counter("t_dup_total", "x") is a
    with pytest.raises(ValueError):
        reg.gauge("t_dup_total", "x")
    with pytest.raises(ValueError):
        reg.histogram("t_dup_total", "x")
    with pytest.raises(ValueError):
        reg.counter("t_dup_total", "x", labels=("k",))


def test_gauge_set_and_histogram_buckets():
    reg = MetricsRegistry()
    g = reg.gauge("t_depth", "queue depth")
    g.set(7)
    g.set(3)
    assert g.get() == 3
    h = reg.histogram("t_lat_seconds", "latency", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v)
    snap = h.snapshot()["values"][0]
    assert snap["buckets"] == [0.01, 0.1, 1.0]
    assert snap["counts"] == [1, 1, 1, 1]  # per bucket, +Inf last
    assert snap["count"] == 4 and snap["sum"] == pytest.approx(5.555)
    reg.reset()
    assert h.snapshot()["values"][0]["count"] == 0 and g.get() == 0


def test_concurrent_increments_sum_exactly():
    reg = MetricsRegistry()
    child = reg.counter("t_conc_total", "x", labels=("who",)).labels(who="all")
    n_threads, per = 8, 10_000

    def work():
        for _ in range(per):
            child.inc()

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert child.value == n_threads * per


def test_disable_makes_mutations_noops(grouped_pair):
    _, eng = grouped_pair
    qs = queries(eng.graph)
    reg = MetricsRegistry()
    c = reg.counter("t_off_total", "x")
    funnel = REGISTRY.get("gnnpe_funnel_total")
    try:
        disable()
        assert not obs.is_enabled()
        c.inc(100)
        before = funnel.get(stage="matches")
        with trace_query("q") as tr:
            assert tr is None
            eng.match_many(qs)
        assert funnel.get(stage="matches") == before
    finally:
        enable()
    assert c.get() == 0
    c.inc()
    assert c.get() == 1


# ------------------------------------------------------------- trace tree --


def test_trace_sampling_deterministic():
    got = []
    for tracer in (TRACER, ref_obs.TRACER):
        tracer.clear()
        old = tracer.trace_rate
        try:
            tracer.trace_rate = 0.25
            got.append([i for i in range(40) if _sampled(tracer, i)])
        finally:
            tracer.trace_rate = old
    assert len(got[0]) == 10  # exactly rate × n, no RNG
    assert got[0] == got[1]
    assert [t.qid for t in TRACER.recent()] == got[0]
    assert len(TRACER.recent(3)) == 3


def _sampled(tracer, i) -> bool:
    with tracer.trace_query(i) as tr:
        return tr is not None


def traced(tracer, fn):
    tracer.trace_rate = 1.0
    with tracer.trace_query("funnel") as tr:
        assert tr is not None
        fn()
    return tr


def partitions(tr) -> list:
    return [(s.attrs["part"], s.attrs["main_rows"], s.attrs["delta_rows"])
            for s in tr.root.find("partition")]


@pytest.mark.parametrize(
    "kind,probe,join",
    [
        ("path", "loop", "numpy"),
        ("path", "stacked", "numpy"),
        ("grouped", "loop", "numpy"),
        ("grouped", "stacked", "numpy"),
        ("path", "stacked", "device"),  # the hand-off
    ],
)
def test_traced_funnel_equals_reference(grouped_pair, kind, probe, join):
    """The five rungs and the per-partition row attributions of one traced
    batch equal the reference's; the funnel equals the pair counters'
    deltas; the stage tree holds each stage once and its stages sum to
    between half and all of the traced wall."""
    ref, eng = grouped_pair
    qs = queries(eng.graph)
    kw = dict(index_kind=kind, probe_impl=probe, join_impl=join)
    want_lists = ref.match_many(qs, **kw)  # compiles outside the trace
    assert eng.match_many(qs, **kw) == want_lists
    pairs = port_index.PAIR_METRIC
    before = (pairs.get(kind="group_pairs"), pairs.get(kind="leaf_pairs"))
    tr = traced(TRACER, lambda: eng.match_many(qs, **kw))
    after = (pairs.get(kind="group_pairs"), pairs.get(kind="leaf_pairs"))
    want = traced(ref_obs.TRACER, lambda: ref.match_many(qs, **kw))
    assert tr.funnel == want.funnel
    assert partitions(tr) == partitions(want)
    assert tr.funnel["group_pairs"] == after[0] - before[0]
    assert tr.funnel["leaf_pairs"] == after[1] - before[1] > 0
    assert 0 < tr.funnel["candidates"] and 0 < tr.funnel["matches"] <= tr.funnel["candidates"]
    assert (tr.funnel["surviving_groups"] > 0) == (kind == "grouped")
    assert tr.funnel["matches"] == sum(len(m) for m in want_lists)
    assert tr.pruning_power() == pytest.approx(want.pruning_power())
    for name in ("embed", "plan", "probe", "assemble", "join"):
        assert len(tr.root.find(name)) == 1, name
    assert [s.attrs["part"] for s in tr.root.find("partition")] == list(range(len(eng.models)))
    stage_s = sum(s.duration_s for s in tr.root.children if s.name in STAGES)
    assert tr.root.duration_s * 0.5 <= stage_s <= tr.root.duration_s * 1.01 + 1e-6
    assert any(t is tr for t in TRACER.recent())
    d = tr.as_dict()
    assert d["funnel"] == tr.funnel
    json.dumps(d)


def test_traced_funnel_under_updates_and_cache_equals_reference(graph):
    """Buffer rows are attributed per partition as the reference does,
    and a cached batch opens ``cache_lookup`` and ``cache_store``."""
    ref, (eng,) = engines(graph, cache=True, delta_compact_min=10**9)
    qs = queries(graph)
    ru, pu = rand_update(np.random.default_rng(4), graph, add=3, remove=3)
    ref.apply_updates(ru)
    eng.apply_updates(pu)
    ref.match_many(qs, join_impl="device")  # compiles the reference's device join
    for kw in (dict(), dict(probe_impl="stacked", join_impl="device")):
        ref._result_cache.clear()
        eng._result_cache.clear()
        tr = traced(TRACER, lambda: eng.match_many(qs, **kw))
        want = traced(ref_obs.TRACER, lambda: ref.match_many(qs, **kw))
        assert tr.funnel == want.funnel
        assert partitions(tr) == partitions(want)
        assert sum(p[2] for p in partitions(tr)) > 0  # buffer rows were probed
        names = [s.name for s in tr.root.children]
        assert names == [s.name for s in want.root.children]
        assert names[0] == "cache_lookup" and names[-1] == "cache_store"
        assert tr.root.find("cache_lookup")[0].attrs == {"hits": 0, "misses": len(qs)}
    hit = traced(TRACER, lambda: eng.match_many(qs))
    assert [s.name for s in hit.root.children] == ["cache_lookup"]
    assert hit.funnel["matches"] == 0  # nothing ran through the pipeline


def test_engine_metrics_observe_every_batch(grouped_pair):
    _, eng = grouped_pair
    qs = queries(eng.graph)
    n_q = REGISTRY.get("gnnpe_engine_queries_total")
    batch = REGISTRY.get("gnnpe_engine_match_batch_seconds")
    stage = REGISTRY.get("gnnpe_engine_stage_seconds")
    funnel = REGISTRY.get("gnnpe_funnel_total")

    def counts():
        snap = {tuple(v["labels"].values()): v["count"] for v in stage.snapshot()["values"]}
        return (n_q.get(), batch.snapshot()["values"][0]["count"], snap,
                funnel.get(stage="candidates"), funnel.get(stage="matches"))

    before = counts()
    lists = eng.match_many(qs)
    after = counts()
    assert after[0] == before[0] + len(qs) and after[1] == before[1] + 1
    for s in ("embed", "plan", "probe", "assemble", "join"):
        assert after[2][(s,)] == before[2].get((s,), 0) + 1, s
    assert after[3] > before[3]
    assert after[4] == before[4] + sum(len(m) for m in lists)


# --------------------------------------------------------------- exporters --


def test_prometheus_round_trip_and_json_snapshot(tmp_path):
    reg = MetricsRegistry()
    c = reg.counter("t_rt_total", "reqs", labels=("status",))
    c.labels(status="ok").inc(3)
    c.labels(status='we"ird\\').inc()
    h = reg.histogram("t_rt_seconds", "lat", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    reg.gauge("t_rt_depth", "depth").set(4)
    text = to_prometheus(reg.snapshot())
    assert "# TYPE t_rt_total counter" in text and "# TYPE t_rt_seconds histogram" in text
    parsed = parse_prometheus(text)
    assert parsed['t_rt_total{status="ok"}'] == 3
    assert parsed['t_rt_seconds_bucket{le="0.1"}'] == 1
    assert parsed['t_rt_seconds_bucket{le="1"}'] == 2  # cumulative
    assert parsed['t_rt_seconds_bucket{le="+Inf"}'] == 2
    assert parsed["t_rt_seconds_count"] == 2
    assert parsed["t_rt_seconds_sum"] == pytest.approx(0.55)
    assert parsed["t_rt_depth"] == 4
    with pytest.raises(ValueError):
        parse_prometheus("not a metric line at all{")
    path = tmp_path / "snap.json"
    write_json_snapshot(path, reg.snapshot(), extra={"run": "t"})
    doc = json.loads(path.read_text())
    assert doc["run"] == "t" and doc["metrics"] == reg.snapshot()
    # the process registry round-trips too
    assert parse_prometheus(to_prometheus()) == parse_prometheus(to_prometheus(REGISTRY.snapshot()))


def test_metrics_http_endpoint():
    reg = MetricsRegistry()
    reg.counter("t_http_total", "x").inc(2)
    with MetricsHTTPServer(port=0, registry=reg) as srv:
        assert srv.host == "127.0.0.1"
        body = urllib.request.urlopen(srv.url, timeout=10).read().decode()
        assert "t_http_total 2" in body
        js = urllib.request.urlopen(srv.url + ".json", timeout=10).read().decode()
        assert json.loads(js)["t_http_total"]["type"] == "counter"


def test_event_log_lines(tmp_path):
    path = tmp_path / "events.jsonl"
    log = EventLog()
    assert not log.active
    log.to_path(path)
    assert log.active
    log.emit("request", rid=1, status="ok")
    log.emit("host_loss", host=2)
    log.close()
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert [e["event"] for e in lines] == ["request", "host_loss"]
    assert lines[0]["rid"] == 1 and "ts" in lines[0]
    assert not EVENTS.active  # the process log stays off until a sink is attached


REFERENCE_METRICS = (
    ("repro.core.engine", "repro_torch.core.engine"),
    ("repro.serve.match_server", "repro_torch.serve.match_server"),
    ("repro.serve.service", "repro_torch.serve.service"),
    ("repro.serve.standing", "repro_torch.serve.standing"),
    ("repro.serve.admission", "repro_torch.serve.admission"),
    ("repro.serve.cache", "repro_torch.serve.cache"),
)


@pytest.mark.parametrize("ref_mod,port_mod", REFERENCE_METRICS)
def test_metrics_named_as_the_reference(ref_mod, port_mod):
    """Every ``_M_*`` metric the reference module registers, the port's
    module registers under the same name, type, help and labels."""
    import importlib

    ref = importlib.import_module(ref_mod)
    port = importlib.import_module(port_mod)
    names = [n for n in vars(ref) if n.startswith("_M_")]
    assert names
    for n in names:
        want, got = getattr(ref, n), getattr(port, n)
        assert (got.name, got.kind, got.help, got.label_names) == (
            want.name, want.kind, want.help, want.label_names), n
        assert REGISTRY.get(got.name) is got
    if ref_mod == "repro.core.engine":
        assert {"_M_QUERIES", "_M_BATCH_S", "_M_STAGE_S", "_M_FUNNEL"} <= set(names)


# ------------------------------------------------- service accounting -----


def _status_counts():
    m = REGISTRY.get("gnnpe_service_request_seconds")
    return {v["labels"]["status"]: v["count"] for v in m.snapshot()["values"]}


def test_faulted_service_counters_sum_to_submitted(grouped_pair):
    """Across a run with a poisoned query and transient faults every
    submitted request lands in exactly one terminal status, in the
    service's counters and in the registry behind ``/metrics``."""
    _, eng = grouped_pair
    qs = queries(eng.graph, n=8)
    flaky = FlakyEngine(eng, FaultSpec(p_transient=0.3, seed=2, poison=lambda q: q is qs[5]))
    svc = MatchService(flaky, ServiceConfig(
        max_batch=4, idle_tick_s=0.02, backoff_base_s=0.005, cache_fastpath=False,
        max_retries=8,
    ))
    before = _status_counts()

    async def run():
        await svc.start()
        resps = await asyncio.gather(*[svc.submit(q)[1] for q in qs])
        await svc.stop()
        return resps

    resps = asyncio.run(asyncio.wait_for(run(), 60))
    c = svc.counters
    statuses = ("ok", "rejected", "shed", "expired", "error", "retry-exhausted")
    assert sum(c[s] for s in statuses) == c["submitted"] == len(qs)
    assert c["error"] == 1 and c["ok"] == len(qs) - 1
    assert [r.status for r in resps].count("error") == 1
    after = _status_counts()
    deltas = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    assert sum(deltas.values()) == len(qs)
    assert deltas.get("error", 0) == 1 and deltas.get("ok", 0) == len(qs) - 1
    parsed = parse_prometheus(to_prometheus())
    assert parsed['gnnpe_service_request_seconds_count{status="error"}'] >= 1
    events = REGISTRY.get("gnnpe_service_events_total")
    assert events.get(event="submitted") >= len(qs)


def test_service_traces_metrics_endpoint_and_events(grouped_pair):
    """``trace_rate`` samples every request: each trace holds its
    admission and queue wait, the tick's lead rider the engine's stage
    spans; ``metrics_port=0`` serves the registry on loopback while the
    service runs; an attached event log records each request, the update
    epoch and the quarantine."""
    import io

    _, eng = grouped_pair
    qs = queries(eng.graph, n=4)
    TRACER.clear()
    sink = io.StringIO()
    flaky = FlakyEngine(eng, FaultSpec(poison=lambda q: q is qs[3]))
    svc = MatchService(flaky, ServiceConfig(
        max_batch=4, idle_tick_s=0.02, cache_fastpath=False, trace_rate=1.0, metrics_port=0,
    ))

    async def run():
        await svc.start()
        url = svc.metrics_server.url
        resps = await asyncio.gather(*[svc.submit(q)[1] for q in qs])
        loop = asyncio.get_running_loop()
        body = await loop.run_in_executor(
            None, lambda: urllib.request.urlopen(url, timeout=10).read().decode())
        await svc.stop()
        return resps, body

    EVENTS.to_stream(sink)
    try:
        resps, body = asyncio.run(asyncio.wait_for(run(), 60))
    finally:
        EVENTS.close()
    assert [r.status for r in resps] == ["ok"] * 3 + ["error"]
    assert svc.metrics_server is None  # closed by stop()
    parsed = parse_prometheus(body)
    assert parsed['gnnpe_service_events_total{event="submitted"}'] >= len(qs)
    traces = TRACER.recent()
    assert sorted(t.qid for t in traces) == [r.request_id for r in resps]
    for tr in traces:
        names = [s.name for s in tr.root.children]
        assert names[0] == "admission" and "queue_wait" in names
        assert tr.root.attrs["status"] in ("ok", "error")
    led = [tr for tr in traces if tr.root.find("join")]
    assert led and led[0].funnel["leaf_pairs"] > 0
    events = [json.loads(line) for line in sink.getvalue().splitlines()]
    kinds = [e["event"] for e in events]
    assert kinds.count("request") == len(qs)
    assert {e["status"] for e in events if e["event"] == "request"} == {"ok", "error"}
