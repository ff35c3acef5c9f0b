"""One run of a cell: set-up, the measured window, the check, the result.

A run makes its data graph and its query pool from the configuration's
and the mix's seeds (``pb_gen``), orders the pool by ``--seed``, hands
both to the program, builds the index, warms it on batches of their
own, and then sends batches of the pool to ``GnnPeEngine.match_many`` in
a closed loop for ``--seconds``: one client, the next batch when the
answers are back, the pool cycled in its seeded order.  Once the window
has closed it reads the card's peak memory, frees the program and
compares a seeded sample of the window's answers with the plain
reference (``pb_ref``).

With ``--trace 1`` each batch of the window runs under an obs trace of
the program (its stage spans), and after the window a slice of further
batches runs under the profiler (``pb_trace.recording``: device busy
time, kernel times, the spans as host ranges), each call of a counted
kernel's op kept as it is made and its work counted once the profiler
has stopped (``rooflines/``).  The per-layer readers take their numbers
from that record.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import math
import statistics
import subprocess
import sys
import time

from pb_bounds import bound_s
from pb_gen import nws_graph, query_pool, rng_for
from pb_manifest import Cell, load_module
from pb_ref import Reference, spanning_tree
from pb_trace import SLICE, SPAN, recording, reduce_slice

__all__ = ["FORBIDDEN", "forbidden_modules", "Inputs", "make_inputs", "PortProgram",
           "ControlProgram", "Record", "run"]

# no module of these top-level names may be loaded in a run (the JAX
# package the port was made from, and JAX itself)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
# the traced slice: at least this many batches and this many seconds
SLICE_BATCHES = 3
SLICE_SECONDS = 2.0


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: loaded modules)."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)


@dataclasses.dataclass(frozen=True)
class Inputs:
    graph: object  # pb_gen.DataGraph
    pool: list  # pb_gen.Query, in the order the window sends them
    warm: list  # queries of the warm-up batches, not in the pool


def make_inputs(config: dict, traffic: dict, seed: int) -> Inputs:
    """The data graph and the queries of a run.  The graph comes from the
    configuration's ``data_seed`` and the pool from the mix's
    ``pool_seed``, made anew in every run; the run's seed orders the pool.
    So every seed sends the same work in another order, and a window
    answers a seeded share of it."""
    gs = config["graph"]
    if gs["generator"] != "newman_watts_strogatz" or gs["label_dist"] != "uniform":
        raise ValueError(f"no generator for {gs['generator']} / {gs['label_dist']} labels")
    if traffic["loop"] != "closed" or traffic["clients"] != 1:
        raise ValueError("the generator drives one closed-loop client")
    g = nws_graph(gs["n_vertices"], gs["k"], gs["p"], gs["n_labels"],
                  rng_for(gs["data_seed"], 1))
    size, deg = traffic["query_vertices"], traffic["query_avg_degree"]
    pool = query_pool(g, traffic["pool"], size, deg, rng_for(traffic["pool_seed"], 2))
    warm = query_pool(g, traffic["warm_batches"] * traffic["batch"], size, deg,
                      rng_for(traffic["pool_seed"], 3))
    order = rng_for(seed, 2).permutation(len(pool))
    return Inputs(g, [pool[i] for i in order], warm)


class PortProgram:
    """The system under test: ``repro_torch``'s engine at the
    configuration's settings, on ``device``."""

    def __init__(self, engine: dict, device: str) -> None:
        self.engine, self.device = engine, device
        self.eng = None

    def items(self, queries: list) -> list:
        from repro_torch.graphs import from_edge_list

        return [from_edge_list(q.n, q.edges, q.labels) for q in queries]

    def build(self, g) -> None:
        from repro_torch.core import GnnPeConfig, GnnPeEngine
        from repro_torch.graphs import from_edge_list

        self.eng = GnnPeEngine(GnnPeConfig(**self.engine), device=self.device)
        self.eng.build(from_edge_list(g.n_vertices, g.edges(), g.labels))

    def match(self, batch: list) -> list:
        return self.eng.match_many(batch)

    def free(self) -> None:
        self.eng = None


class ControlProgram:
    """The control: the plain reference in the program's place, with one
    guarantee broken — it holds only a spanning tree of each query's
    edges, as a matcher that skips the refine of the non-tree edges."""

    device = "cpu"

    def items(self, queries: list) -> list:
        return [spanning_tree(q) for q in queries]

    def build(self, g) -> None:
        self.ref = Reference(g)

    def match(self, batch: list) -> list:
        return [self.ref.match(q) for q in batch]

    def free(self) -> None:
        self.ref = None


@dataclasses.dataclass
class Record:
    """What a run measured, as the metric readers see it."""

    queries: int = 0  # answered in the window
    window_s: float = 0.0
    setup_s: float = 0.0
    build_s: float = 0.0
    batch_s: list = dataclasses.field(default_factory=list)  # each batch of the window
    stage_s: list = dataclasses.field(default_factory=list)  # per batch: span -> s (traced)
    leaf_pairs: float | None = None  # the probe's leaf-pair counter over the window
    profile: dict | None = None  # the traced slice (pb_trace.reduce_slice, + rooflines)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _span_seconds(tr) -> dict:
    out: dict = {}
    stack = list(tr.root.children)
    while stack:
        s = stack.pop()
        out[s.name] = out.get(s.name, 0.0) + s.duration_s
        stack.extend(s.children)
    return out


def _pair_counter():
    from repro_torch.obs.metrics import REGISTRY

    return REGISTRY.get("gnnpe_probe_pairs_total")


@contextlib.contextmanager
def _mirrored_spans():
    """Open a profiler range ``span:<name>`` around every obs span."""
    from torch.profiler import record_function

    from repro_torch.obs.trace import TRACER

    plain = TRACER.span

    @contextlib.contextmanager
    def span(name, **attrs):
        with record_function(SPAN + name), plain(name, **attrs) as s:
            yield s

    TRACER.span = span
    try:
        yield
    finally:
        del TRACER.span


@contextlib.contextmanager
def _kept_calls(kernels: dict):
    """Wrap each kernel module's ops wherever the program holds them; each
    call's ``keep`` (no device work) lands in the yielded {module: [kept]}."""
    kept = {name: [] for name in kernels}
    patches = []
    for name, km in kernels.items():
        for modname, attr in km.OPS:
            orig = getattr(importlib.import_module(modname), attr)

            def wrapped(*a, _orig=orig, _km=km, _attr=attr, _into=kept[name], **kw):
                out = _orig(*a, **kw)
                k = _km.keep(_attr, a, kw)
                if k is not None:
                    _into.append(k)
                return out

            for m in list(sys.modules.values()):
                if (getattr(m, "__name__", "").split(".")[0] == "repro_torch"
                        and getattr(m, attr, None) is orig):
                    setattr(m, attr, wrapped)
                    patches.append((m, attr, orig))
    try:
        yield kept
    finally:
        for m, attr, orig in patches:
            setattr(m, attr, orig)


def _profile(match, batches: list, sync, kernels: dict, cuda: bool) -> dict | None:
    """The slice under the profiler → ``reduce_slice``'s numbers and, for
    each kernel module, the least time of its calls' work against its
    kernels' device time (counted once the profiler has stopped)."""
    from torch.profiler import record_function

    from repro_torch.obs.trace import TRACER

    t = time.perf_counter()
    with _kept_calls(kernels) as kept, _mirrored_spans(), recording(cuda) as events:
        with record_function(SLICE):
            for i, b in enumerate(batches):
                with TRACER.trace_query(("slice", i)), record_function(SPAN + "match_many"):
                    match(b)
                    sync()
        t_slice = time.perf_counter()
    t_stop = time.perf_counter()
    out = reduce_slice(events)
    if out is not None:
        out["rooflines"] = {}
        for name, km in kernels.items():
            hits = [v for k, v in out["kernels"].items() if km.KERNEL in k]
            out["rooflines"][name] = {
                "bound_s": sum(bound_s(*km.work(k)) for k in kept[name]),
                "calls": len(kept[name]),
                "kernel_s": sum(v[0] for v in hits), "launches": sum(v[1] for v in hits),
            }
    _log(f"profile: {len(batches)} batches in {t_slice - t:.3f} s, {len(events)} events "
         f"read in {t_stop - t_slice:.3f} s, reduced and counted in "
         f"{time.perf_counter() - t_stop:.3f} s")
    return out


def _check(inputs: Inputs, answers: list, n: int, seed: int) -> dict:
    """Compare a seeded sample of the window's answers (and the one with
    the most matches) with the reference → the numbers compared."""
    import numpy as np

    ref = Reference(inputs.graph)
    picks = set()
    if answers:
        rng = rng_for(seed, 4)
        picks = set(rng.choice(len(answers), size=min(n, len(answers)), replace=False).tolist())
        picks.add(int(np.argmax([len(a) for _, a in answers])))
    want: dict = {}
    bad = missing = spurious = 0
    for i in sorted(picks):
        qi, got = answers[i]
        if qi not in want:
            want[qi] = set(ref.match(inputs.pool[qi]))
        tuples = [tuple(int(x) for x in m) for m in got]
        have = set(tuples)
        miss = len(want[qi] - have)
        spur = len(have - want[qi]) + len(tuples) - len(have)
        missing += miss
        spurious += spur
        bad += bool(miss or spur)
    return {
        "compared_queries": {"value": len(picks), "at_least": 1},
        "mismatched_queries": {"value": bad, "limit": 0},
        "missing_matches": {"value": missing, "limit": 0},
        "spurious_matches": {"value": spurious, "limit": 0},
    }


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
        program=None, wrap_match=None) -> tuple[dict, Record]:
    """One run → (the result line's object, its key ``compared`` last;
    the record).  ``program`` defaults to the port on the card;
    ``wrap_match`` wraps its ``match`` (the tests plant faults there)."""
    import torch

    traffic = cell.traffic
    if program is None:
        program = PortProgram(cell.config["engine"], "cuda")
    cuda = program.device == "cuda"

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize()

    rec = Record()
    t = time.perf_counter()
    inputs = make_inputs(cell.config, traffic, seed)
    pool, warm = program.items(inputs.pool), program.items(inputs.warm)
    _log(f"inputs: {inputs.graph.n_vertices} vertices, {inputs.graph.nbrs.shape[0] // 2} "
         f"edges, {len(pool)} + {len(warm)} queries in {time.perf_counter() - t:.3f} s")
    sync()
    t = time.perf_counter()
    program.build(inputs.graph)
    sync()
    rec.build_s = time.perf_counter() - t
    match = program.match if wrap_match is None else wrap_match(program.match)
    B = traffic["batch"]
    for i in range(0, len(warm), B):
        match(warm[i: i + B])
        sync()
    counter = _pair_counter() if isinstance(program, PortProgram) else None
    leaf0 = counter.get(kind="leaf_pairs") if counter is not None else None
    if trace:
        from repro_torch.obs.trace import TRACER
    answers: list = []
    pos, P = 0, len(pool)
    w0 = time.perf_counter()
    rec.setup_s = w0 - t_start
    end = w0 + seconds
    while True:
        t = time.perf_counter()
        if t >= end and rec.batch_s:
            break
        idx = [(pos + i) % P for i in range(B)]
        pos += B
        batch = [pool[i] for i in idx]
        if trace:
            with TRACER.trace_query(("window", len(rec.batch_s))) as tr:
                got = match(batch)
                sync()
            rec.stage_s.append(_span_seconds(tr) if tr is not None else {})
        else:
            got = match(batch)
            sync()
        rec.batch_s.append(time.perf_counter() - t)
        answers.extend(zip(idx, got))
    rec.window_s = time.perf_counter() - w0
    rec.queries = len(answers)
    if counter is not None:
        rec.leaf_pairs = counter.get(kind="leaf_pairs") - leaf0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    _log(f"window: {len(rec.batch_s)} batches of {B}, {rec.queries} queries in "
         f"{rec.window_s:.3f} s; batch median {statistics.median(rec.batch_s) * 1e3:.3f} ms, "
         f"max {max(rec.batch_s) * 1e3:.3f} ms")
    if trace:
        kernels = {}
        for m in cell.per_layer:
            name = getattr(load_module("metrics", m["name"]), "ROOFLINE", None)
            if name:
                kernels[name] = load_module("rooflines", name)
        n_slice = max(SLICE_BATCHES, math.ceil(SLICE_SECONDS / statistics.median(rec.batch_s)))
        batches = [[pool[(pos + j * B + i) % P] for i in range(B)] for j in range(n_slice)]
        rec.profile = _profile(match, batches, sync, kernels, cuda)
    program.free()
    del match
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    compared = _check(inputs, answers, traffic["compare"], seed)
    _log(f"check: reference over {compared['compared_queries']['value']} queries in "
         f"{time.perf_counter() - t:.3f} s")
    correct = compared["compared_queries"]["value"] >= 1 and all(
        v["value"] <= v["limit"] for v in compared.values() if "limit" in v)
    device = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name() if cuda else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
        "power": _power_limit() if cuda else "none",
    }
    if trace and rec.profile is not None:
        device["busy_s"] = rec.profile["busy_s"]
        device["window_s"] = rec.profile["window_s"]
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": rec.queries, "failed": 0,
              "metrics": metrics, "device": device}
    if trace and rec.profile is not None:
        result["breakdown"] = {k: rec.profile[k] for k in ("device_ops", "idle_gaps")}
    result["compared"] = compared
    return result, rec
