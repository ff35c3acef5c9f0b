#!/usr/bin/env python3
"""Time ``benchmarks/bench_updates.py --full``'s update loop stage by stage,
on the JAX package or on the PyTorch port, to show where an update's time
goes on one host.

    JAX_PLATFORMS=cpu python3 tools/update_stages.py --impl ref
    python3 tools/update_stages.py --impl port [--device cuda|cpu]

The cell is the bench's: a 10K-vertex NWS graph (seed 13) in 40 partitions,
the grouped index (group size 16), compaction at max(192, 0.08 x paths)
rows, and 6 batches of 4 removed and 4 added edges drawn by
``default_rng(0)``, applied to one engine with ``strategy="delta"`` and to
another with ``strategy="rebuild"``; the match sets of 8 queries are held
equal after every batch.  Each stage's host ms (to a synchronize on the
card, less the stages it calls) comes from ``chip_smoke.StageClock`` over
``chip_smoke.update_stages``, whose names are the same in both packages.
``chip_smoke.py`` phase 8b runs the same loop on the card with a stacked
probe kept on the delta engine.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import StageClock, update_stages  # noqa: E402


def modules(impl: str, device: str):
    """(core, engine, delta, probe, graphs modules, engine kwargs, finish)."""
    if impl == "ref":
        from repro import core, graphs
        from repro.core import delta, engine
        from repro.dist import probe

        return core, engine, delta, probe, graphs, {}, lambda: None
    import torch

    from repro_torch import core, graphs
    from repro_torch.core import delta, engine
    from repro_torch.dist import probe

    dev = torch.device(device)
    finish = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    return core, engine, delta, probe, graphs, {"device": dev}, finish


def rand_update(core, rng, g):
    """``benchmarks/bench_updates.py``'s edit batch, drawn in its order."""
    e = g.edge_array()
    remove = e[rng.choice(e.shape[0], size=4, replace=False)]
    return core.GraphUpdate(add_edges=rng.integers(0, g.n_vertices, size=(4, 2)),
                            remove_edges=remove)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--impl", choices=("ref", "port"), required=True)
    ap.add_argument("--device", default="cuda", help="the port's device (default cuda)")
    args = ap.parse_args()
    core, engine_mod, delta_mod, probe_mod, graphs, kw, finish = modules(args.impl, args.device)

    g = graphs.newman_watts_strogatz(10_000, k=4, p=0.1, n_labels=100, seed=13)
    base = dict(n_partitions=10_000 // 250, encoder="monotone", index_kind="grouped",
                group_size=16, train=core.TrainConfig(max_epochs=150))
    eng = core.GnnPeEngine(core.GnnPeConfig(**base, delta_compact_min=192,
                                            delta_compact_frac=0.08), **kw).build(g)
    reb = core.GnnPeEngine(core.GnnPeConfig(**base), **kw).build(g)
    queries = []
    for s in range(8):
        try:
            queries.append(graphs.random_connected_query(g, 8, seed=77 + s))
        except RuntimeError:
            continue
    stages = update_stages(engine_mod, delta_mod, probe_mod)
    clocks = {k: StageClock(stages, finish) for k in ("delta", "rebuild")}
    wall = {"delta": 0.0, "rebuild": 0.0}
    n_mutated = 0
    rng = np.random.default_rng(0)
    for b in range(6):
        upd = rand_update(core, rng, eng.graph)
        for strategy, e in (("delta", eng), ("rebuild", reb)):
            with clocks[strategy]:
                t = time.perf_counter()
                s = e.apply_updates(upd, strategy=strategy)
                finish()
                wall[strategy] += (time.perf_counter() - t) * 1e3
            n_mutated += len(s["mutated"]) * (strategy == "delta")
        got = [core.sort_matches(m) for m in eng.match_many(queries)]
        if got != [core.sort_matches(m) for m in reb.match_many(queries)]:
            raise AssertionError(f"batch {b}: delta and rebuild match sets differ")
    where = "the JAX package on the CPU" if args.impl == "ref" else f"the port on {args.device}"
    print(f"{where}: delta {wall['delta']:.3f} ms, rebuild {wall['rebuild']:.3f} ms over 6 "
          f"batches, speedup {wall['rebuild'] / max(wall['delta'], 1e-12):.2f}x; compactions "
          f"{eng.delta_stats()['n_compactions']}; match sets identical at every batch")
    for strategy, n_parts in (("delta", n_mutated), ("rebuild", 6 * len(reb.models))):
        print(f"{strategy} stages (ms / calls): {clocks[strategy].report(wall[strategy])}; "
              f"{n_parts} partitions re-indexed, {wall[strategy] / max(n_parts, 1):.3f} ms each")
    return 0


if __name__ == "__main__":
    sys.exit(main())
