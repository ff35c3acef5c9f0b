"""The serving tier of the PyTorch port end to end: build the GNN-PE index
over a larger graph on the card, then serve a stream of subgraph-matching
requests through the batched ``MatchServer`` (every tick fuses up to
``--batch`` queries into one ``match_many``: one star embedding, one
probe, one K1 verdict) and report latency percentiles and throughput,
checking exactness on a sample.  The port's counterpart of
``examples/serve_queries.py``, with its main flags.

``--update-every K`` queues one random edge insertion/deletion batch every
K requests (``submit_update``), and the server interleaves update ticks
(delta index epochs) with query ticks.  ``--cache`` turns on the
signature-keyed result cache.  ``--join-impl device`` runs the batched
device join (K2), ``--probe-impl stacked`` the stacked probe, and
``--schedule cost`` orders each tick by the engine's cached plan cost.

``--service`` serves through the async multi-tenant tier
(``repro_torch.serve.service``): admission, deadlines, bounded queues,
retries with backoff and background compaction, reporting p50 / p95 / p99
and the shed, expired and retry counters.  ``--fault-rate P`` wraps the
engine in the fault injector: each tick raises a transient fault with
probability P, and every request must still complete exactly, by retries.
``--subscribe`` (with ``--service``) registers standing queries first and
checks, at the final epoch, that no delta was lost and each
subscription's replayed deltas equal a from-scratch match.  ``--metrics``
exports the registry and proves from the text alone that every request
reached one terminal state.

The engine runs on the card (``--device cuda``, the default) and exits
with an error where there is none; ``--device cpu`` runs the same stream
on the CPU with the kernels' plain versions.

``--wal DIR`` runs the durable tick loop (``repro_torch.durability``): the
server journals every update epoch to a checksummed, fsync'd WAL under DIR
and snapshots every ``--snapshot-every`` epochs.  The update stream is
computed in advance from a shadow graph, so a run over the same DIR
resumes: recovery restores the newest valid snapshot on the device,
replays the WAL suffix, and the driver skips the epochs already applied.
The run ends with the engine fingerprint and a match digest over a fixed
query set: a run killed with SIGKILL and started again prints the same
``[wal] final ...`` line as one that never crashed.

    PYTHONPATH=src python examples/serve_queries_torch.py [--n 4000] [--requests 60]
    PYTHONPATH=src python examples/serve_queries_torch.py --update-every 5 --cache
    PYTHONPATH=src python examples/serve_queries_torch.py --service --fault-rate 0.2
    PYTHONPATH=src python examples/serve_queries_torch.py --service --subscribe \
        --update-every 3 --fault-rate 0.15 --metrics
    PYTHONPATH=src python examples/serve_queries_torch.py --device cpu --n 1500 --requests 20
    PYTHONPATH=src python examples/serve_queries_torch.py --wal /tmp/dur --wal-updates 10
"""
import argparse
import asyncio
import hashlib
import json
import time

import numpy as np

from repro_torch.core import GnnPeConfig, GnnPeEngine, GraphUpdate, apply_graph_update, vf2_match
from repro_torch.graphs import newman_watts_strogatz, random_connected_query
from repro_torch.obs import parse_prometheus, to_prometheus, write_json_snapshot
from repro_torch.serve import (
    FaultSpec,
    FlakyEngine,
    MatchServeConfig,
    MatchServer,
    MatchService,
    ServiceConfig,
)

#: terminal request states the service accounts every submit into
_STATUSES = ("ok", "rejected", "shed", "expired", "error", "retry-exhausted")


def _metrics_report(n_submitted: int, service: bool, json_path: str | None) -> None:
    """``--metrics``: export the registry and prove, from the exported
    text alone, that zero requests were lost — every submitted request
    is accounted in exactly one terminal-status counter."""
    text = to_prometheus()
    parsed = parse_prometheus(text)  # raises on any malformed line
    if service:
        def _count(s):
            return int(parsed.get('gnnpe_service_request_seconds_count{status="%s"}' % s, 0))

        total = sum(_count(s) for s in _STATUSES)
        detail = " ".join(f"{s}={_count(s)}" for s in _STATUSES)
    else:
        total = int(parsed.get("gnnpe_server_queries_total", 0))
        detail = f"ticks={int(parsed.get('gnnpe_server_tick_seconds_count', 0))}"
    assert total == n_submitted, (
        f"metrics accounting hole: {total} requests in terminal counters "
        f"vs {n_submitted} submitted"
    )
    if json_path:
        write_json_snapshot(json_path)
    print(
        f"[metrics] {len(parsed)} series exported, parse ok | "
        f"{total}/{n_submitted} requests accounted ({detail})"
        + (f" | snapshot → {json_path}" if json_path else "")
    )


async def _run_service(engine, args, rng):
    """The async tier: admission → priority queue → tick executor."""
    flaky = None
    if args.fault_rate > 0:
        flaky = FlakyEngine(engine, FaultSpec(p_transient=args.fault_rate, seed=0))
    svc = MatchService(
        flaky or engine,
        ServiceConfig(
            max_batch=args.batch,
            index_kind=None,
            schedule="deadline",
            default_deadline_s=args.deadline,
            max_retries=8,
            backoff_base_s=0.01,
            backoff_max_s=0.1,
            idle_tick_s=0.02,
            cache_fastpath=args.cache,
        ),
    )
    await svc.start()
    subs = []
    if args.subscribe:
        for i in range(6):
            try:
                sq = random_connected_query(engine.graph, 5 + i % 2, seed=2000 + i)
            except RuntimeError:
                continue
            handle = await svc.subscribe(sq, tenant=f"tenant-{i % 3}")
            assert handle.ok, f"subscription rejected: {handle.reason}"
            subs.append((handle, sq))
    sent = []
    t_serve = time.perf_counter()
    for r in range(args.requests):
        size = int(rng.choice([5, 6, 8]))
        try:
            q = random_connected_query(engine.graph, size, seed=1000 + r)
        except RuntimeError:
            continue
        _, fut = svc.submit(q, tenant=f"tenant-{r % 3}")
        sent.append((r, q, fut))
        if args.update_every and (r + 1) % args.update_every == 0:
            cur = engine.graph
            e = cur.edge_array()
            svc.submit_update(GraphUpdate(
                add_edges=rng.integers(0, cur.n_vertices, size=(2, 2)),
                remove_edges=e[rng.choice(e.shape[0], size=2, replace=False)],
            ))
        await asyncio.sleep(0)  # arrival yields: ticks interleave with submits
    resps = await asyncio.gather(*(f for _, _, f in sent))
    wall = time.perf_counter() - t_serve
    if subs:
        # wait for every subscription to reach the final epoch — the serve
        # loop's heartbeat retries transiently-faulted subscription ticks
        while svc.server.standing_lagging():
            await asyncio.sleep(0.02)
        await asyncio.sleep(0.05)  # let queued threadsafe deliveries flush
        loop = asyncio.get_running_loop()
        refs = await loop.run_in_executor(
            svc._engine_pool, lambda: engine.match_many([q for _, q in subs])
        )
        n_deltas = 0
        for (handle, _), ref in zip(subs, refs):
            assert handle.ok, \
                f"subscription {handle.sub_id} lost: {handle.status} ({handle.reason})"
            acc: set = set()
            while not handle.deltas.empty():
                d = handle.deltas.get_nowait()
                assert not d.error, f"terminal subscription error: {d.error}"
                n_deltas += 1
                acc = (acc - set(d.retracted)) | set(d.added)
            assert acc == {tuple(int(v) for v in m) for m in ref}, \
                "incremental delta replay != from-scratch match at final epoch"
        print(
            f"[service] standing: {len(subs)} subscriptions, {n_deltas} deltas, "
            f"zero lost — incremental ≡ from-scratch at the final epoch"
        )
    await svc.stop()

    ok = [resp for resp in resps if resp.ok]
    assert len(resps) == len(sent), "a request was lost without a terminal response"
    verified = 0
    if not args.update_every:  # static graph: ok answers must equal VF2's
        for (r, q, _), resp in zip(sent, resps):
            if resp.ok and r % args.verify_every == 0:
                assert set(resp.matches) == set(vf2_match(engine.graph, q)), \
                    f"request {r}: mismatch!"
                verified += 1
    lat_ms = np.sort(np.asarray([resp.latency_s for resp in ok])) * 1e3
    c = svc.counters
    print(
        f"[service] {len(ok)}/{len(resps)} ok in {wall:.1f}s → {len(ok)/wall:.1f} qps | "
        f"p50={lat_ms[len(lat_ms)//2]:.1f}ms "
        f"p95={lat_ms[min(int(len(lat_ms)*0.95), len(lat_ms)-1)]:.1f}ms "
        f"p99={lat_ms[min(int(len(lat_ms)*0.99), len(lat_ms)-1)]:.1f}ms | "
        f"exactness verified on {verified} samples"
    )
    print(
        f"[service] shed={c['shed']} expired={c['expired']} rejected={c['rejected']} "
        f"error={c['error']} retry-exhausted={c['retry-exhausted']} | "
        f"retries={c['retries']} timeouts={c['attempt_timeouts']} "
        f"cache_fastpath={c['cache_fastpath']} | "
        f"compactions installed={c['compactions_installed']} "
        f"discarded={c['compactions_discarded']}"
    )
    if flaky is not None:
        assert c["error"] == 0 and c["retry-exhausted"] == 0, \
            "transient faults must be absorbed by retries, not surfaced"
        print(
            f"[service] chaos: {flaky.n_transient} transient faults over "
            f"{flaky.n_calls} engine calls — all requests still exact"
        )
    ticks = svc.tick_stats()
    if ticks:
        tms = np.sort(np.asarray([t["wall_s"] for t in ticks])) * 1e3
        n_err = sum(t["n_errors"] for t in ticks)
        print(
            f"[service] {len(ticks)} query ticks: tick p50={tms[len(tms)//2]:.1f}ms "
            f"p95={tms[min(int(len(tms)*0.95), len(tms)-1)]:.1f}ms | "
            f"{n_err} per-tick error entries"
        )
    if args.metrics:
        _metrics_report(len(resps), service=True, json_path=args.metrics_json)


def _run_wal(engine, g, args):
    """The durable tick loop: journal every epoch, snapshot on the cadence,
    and end with a state digest a restarted replica must reproduce →
    ``(epoch, fingerprint, match digest)``.  ``engine`` serves only a fresh
    directory; a directory with a snapshot is recovered."""
    from repro_torch.durability import (
        DurabilityConfig,
        RecoveryError,
        engine_fingerprint,
        recover_server,
    )

    dcfg = DurabilityConfig(args.wal, snapshot_every=args.snapshot_every)
    try:
        server, info = recover_server(dcfg, MatchServeConfig(max_batch=args.batch),
                                      device=args.device)
        engine = server.engine
        print(
            f"[wal] recovered: snapshot epoch {info['snapshot_epoch']} + "
            f"{info['replayed']} replayed WAL epochs → epoch {info['epoch']} "
            f"({info['truncated_bytes']} torn-tail bytes dropped, "
            f"{info['recovery_s']*1e3:.0f}ms)"
        )
    except RecoveryError:
        # a fresh directory: the seeded build is deterministic, so a crash
        # before the genesis snapshot just builds the identical engine again
        server = MatchServer(engine, MatchServeConfig(max_batch=args.batch, durability=dcfg))
        print("[wal] fresh directory: genesis snapshot at epoch 0")

    # the update stream is a pure function of the args: a shadow graph makes
    # update k well defined however many epochs the recovered engine applied
    shadow = g
    updates = []
    rng_u = np.random.default_rng(12345)
    for _ in range(args.wal_updates):
        e = shadow.edge_array()
        u = GraphUpdate(
            add_edges=rng_u.integers(0, shadow.n_vertices, size=(2, 2)),
            remove_edges=e[rng_u.choice(e.shape[0], size=2, replace=False)],
        )
        updates.append(u)
        shadow, _ = apply_graph_update(shadow, u)

    start = int(engine.epoch)
    assert start <= len(updates), f"the directory is ahead of the stream ({start} epochs)"
    for k in range(start, len(updates)):
        try:
            server.submit(random_connected_query(g, 5, seed=3000 + k))
            server.step()
        except RuntimeError:
            pass
        server.submit_update(updates[k])
        server.apply_update_tick()
        print(f"[wal] epoch {k + 1}/{len(updates)}", flush=True)
    server.run_until_drained()

    probes = []
    for i in range(6):
        try:
            probes.append(random_connected_query(g, 5 + i % 2, seed=4000 + i))
        except RuntimeError:
            continue
    matches = engine.match_many(probes)
    digest = hashlib.blake2b(
        json.dumps([sorted(m) for m in matches]).encode(), digest_size=8
    ).hexdigest()
    final = (int(engine.epoch), engine_fingerprint(engine), digest)
    print(f"[wal] final epoch={final[0]} fingerprint={final[1]} match_digest={final[2]}")
    return final


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--requests", type=int, default=60)
    ap.add_argument("--batch", type=int, default=6)
    ap.add_argument("--verify-every", type=int, default=10)
    ap.add_argument("--labels", type=int, default=50, help="vertex labels of the graph")
    ap.add_argument("--graph-seed", type=int, default=0, help="seed of the graph")
    ap.add_argument(
        "--index-kind", choices=["path", "grouped"], default="grouped",
        help="probe layer: per-path leaf scan, or the GNN-PGE two-level group probe",
    )
    ap.add_argument("--group-size", type=int, default=16)
    ap.add_argument(
        "--probe-impl", choices=["loop", "stacked"], default="loop",
        help="index traversal: per-partition Python loop, or the stacked-"
        "tensor probe vmapped/sharded over the local devices",
    )
    ap.add_argument(
        "--join-impl", choices=["numpy", "device"], default="numpy",
        help="candidate join + refine: the host sort-merge join, or the "
        "jitted device merge-join pipeline (kernels/merge_join)",
    )
    ap.add_argument(
        "--schedule", choices=["fifo", "cost"], default="fifo",
        help="tick scheduling: submission order, or cost-ranked by the "
        "engine's cached plan cost (cheap queries first)",
    )
    ap.add_argument(
        "--update-every", type=int, default=0,
        help="mixed live stream: queue one random edge add/remove batch "
        "every N requests (0 = query-only stream)",
    )
    ap.add_argument(
        "--cache", action="store_true",
        help="enable the signature-keyed result cache (serve/cache.py)",
    )
    ap.add_argument(
        "--service", action="store_true",
        help="serve through the async multi-tenant tier (serve/service.py) "
        "instead of the bare tick loop: admission, deadlines, retries",
    )
    ap.add_argument(
        "--subscribe", action="store_true",
        help="with --service: register standing queries and assert that "
        "their accumulated incremental deltas equal a from-scratch match "
        "at the final epoch, with zero deltas lost",
    )
    ap.add_argument(
        "--fault-rate", type=float, default=0.0,
        help="with --service: inject a transient engine fault per tick with "
        "this probability (chaos smoke; requests must survive via retries)",
    )
    ap.add_argument(
        "--deadline", type=float, default=30.0,
        help="with --service: per-request deadline in seconds",
    )
    ap.add_argument(
        "--metrics", action="store_true",
        help="export the obs registry at the end of the run (Prometheus "
        "text) and assert, from the exported counters alone, that every "
        "submitted request reached exactly one terminal state",
    )
    ap.add_argument(
        "--metrics-json", default=None,
        help="with --metrics: also write the registry snapshot as JSON "
        "to this path",
    )
    ap.add_argument(
        "--wal", default=None, metavar="DIR",
        help="durable tick loop: WAL + snapshots under DIR; a run over the same "
        "DIR recovers and resumes the deterministic update stream",
    )
    ap.add_argument(
        "--wal-updates", type=int, default=10,
        help="with --wal: length of the deterministic update stream",
    )
    ap.add_argument(
        "--snapshot-every", type=int, default=4,
        help="with --wal: epochs between snapshots",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="where the engine runs: the card (default) or 'cpu'",
    )
    args = ap.parse_args()

    g = newman_watts_strogatz(args.n, k=4, p=0.1, n_labels=args.labels, seed=args.graph_seed)
    print(f"[offline] building index over |V|={g.n_vertices} |E|={g.n_edges} "
          f"on {args.device} ...")
    t0 = time.perf_counter()
    engine = GnnPeEngine(
        GnnPeConfig(
            encoder="monotone", n_partitions=max(args.n // 1000, 1), n_multi=2,
            index_kind=args.index_kind, group_size=args.group_size,
            probe_impl=args.probe_impl, join_impl=args.join_impl,
            cache=args.cache,
        ),
        device=args.device,
    ).build(g)
    if args.probe_impl == "stacked":
        print(
            f"[offline] stacked probe: {engine.offline_stats['stacked_bytes']/1e6:.1f} MB "
            f"stacked tensors ({engine.offline_stats['stacked_padding_frac']:.0%} padding)"
        )
    grp = (
        f", {engine.offline_stats['n_groups']} groups"
        if args.index_kind == "grouped"
        else ""
    )
    print(f"[offline] done in {time.perf_counter()-t0:.1f}s "
          f"({engine.offline_stats['n_paths']} paths{grp}, "
          f"{engine.offline_stats['index_bytes']/1e6:.1f} MB index)")

    rng = np.random.default_rng(0)
    if args.wal:
        _run_wal(engine, g, args)
        return
    if args.service:
        asyncio.run(_run_service(engine, args, rng))
        return

    # request stream: mixed query sizes, fused into batches by MatchServer;
    # with --update-every, update ticks interleave with the query ticks
    server = MatchServer(
        engine, MatchServeConfig(max_batch=args.batch, schedule=args.schedule)
    )
    sent = {}
    verifiable = set()  # rids served at the final graph epoch
    t_serve = time.perf_counter()
    for r in range(args.requests):
        size = int(rng.choice([5, 6, 8]))
        try:
            q = random_connected_query(g, size, seed=1000 + r)
        except RuntimeError:
            continue
        rid = server.submit(q)
        sent[rid] = (r, q)
        verifiable.add(rid)
        if args.update_every and (r + 1) % args.update_every == 0:
            cur = engine.graph
            e = cur.edge_array()
            rem = e[rng.choice(e.shape[0], size=2, replace=False)]
            add = rng.integers(0, cur.n_vertices, size=(2, 2))
            server.submit_update(GraphUpdate(add_edges=add, remove_edges=rem))
            # queries submitted before this update may be served pre-epoch;
            # only later ones are checked against the final graph
            server.run_until_drained()
            verifiable.clear()
        elif len(server.queue) >= args.batch:
            server.step()
    out = server.run_until_drained()
    wall = time.perf_counter() - t_serve
    n_matches = sum(len(m) for m in out.values())
    verified = 0
    final_g = engine.graph
    for rid, (r, q) in sent.items():
        if rid in verifiable and (args.update_every or r % args.verify_every == 0):
            # spot-check exactness in production (vs the live graph);
            # under a mixed stream every final-epoch request is checked
            assert set(out[rid]) == set(vf2_match(final_g, q)), f"request {r}: mismatch!"
            verified += 1
    # service time (the fused tick a request rode in) — queue wait from the
    # pre-loaded backlog would swamp the percentiles and mislead
    lat = [server.service_s[rid] for rid in sent]
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    print(
        f"[serve] {len(lat)} requests in {wall:.1f}s → {len(lat)/wall:.1f} qps | "
        f"service p50={lat_ms[len(lat)//2]:.1f}ms p95={lat_ms[int(len(lat)*0.95)]:.1f}ms "
        f"p99={lat_ms[min(int(len(lat)*0.99), len(lat)-1)]:.1f}ms | "
        f"{n_matches} total matches | exactness verified on {verified} samples"
    )
    ticks = [t["wall_s"] for t in server.tick_stats]
    if ticks:
        tms = np.sort(np.asarray(ticks)) * 1e3
        spans = [
            (t["min_cost"], t["max_cost"])
            for t in server.tick_stats
            if t["max_cost"] is not None
        ]
        span_txt = (
            f" | cost span (last tick) {spans[-1][0]:.0f}..{spans[-1][1]:.0f}"
            if spans
            else ""
        )
        print(
            f"[serve] {len(ticks)} query ticks ({args.schedule}): "
            f"tick p50={tms[len(tms)//2]:.1f}ms "
            f"p95={tms[min(int(len(tms)*0.95), len(tms)-1)]:.1f}ms{span_txt}"
        )
    if server.n_updates_applied:
        ds = engine.delta_stats()
        print(
            f"[serve] live updates: {server.n_updates_applied} applied over "
            f"{len(server.update_s)} ticks (epoch {ds['epoch']}, "
            f"{ds.get('n_compactions', 0)} compactions, "
            f"{ds.get('delta_rows', 0)} delta rows, {ds.get('tombstones', 0)} tombstones)"
        )
    if args.cache and engine._result_cache is not None:
        cs = engine._result_cache.stats
        print(
            f"[serve] result cache: {cs.hits} hits / {cs.misses} misses "
            f"(hit rate {cs.hit_rate():.0%}), {cs.invalidated} invalidated"
        )
    if args.metrics:
        _metrics_report(len(sent), service=False, json_path=args.metrics_json)


if __name__ == "__main__":
    main()
