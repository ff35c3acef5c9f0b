"""Serving launcher: the exact subgraph-query service, and an LM decode
mode over the ``DecodeEngine`` (the JAX package's ``launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --mode gnnpe --n 2000 --requests 40
    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm --arch deepseek-v2-lite-16b --requests 8

``--mode gnnpe`` builds the GNN-PE index over a Newman-Watts-Strogatz graph
and answers random connected queries one ``match`` at a time, every tenth
checked against VF2.  ``--mode lm`` serves ``--requests`` prompts of 8
tokens through continuous batching over 4 slots with any LM of the
registry at its smoke width (its cache GQA's or MLA's).  Both run on the
card unless ``--device cpu`` is given; without a card they raise.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..device import default_device


def serve_gnnpe(args, dev) -> dict:
    from ..core import GnnPeConfig, GnnPeEngine, vf2_match
    from ..graphs import newman_watts_strogatz, random_connected_query

    g = newman_watts_strogatz(args.n, k=4, p=0.1, n_labels=50, seed=0)
    print(f"[serve] building GNN-PE index on {dev}: |V|={g.n_vertices} |E|={g.n_edges}")
    eng = GnnPeEngine(
        GnnPeConfig(encoder=args.encoder, n_partitions=max(args.n // 1000, 1), n_multi=2,
                    quantize_index=args.quantize),
        device=dev,
    ).build(g)
    st = eng.offline_stats
    print(f"[serve] offline {st['total_time']:.1f}s, {st['n_paths']} paths, "
          f"{st['index_bytes'] / 1e6:.1f} MB")
    lat, checked = [], 0
    for r in range(args.requests):
        try:
            q = random_connected_query(g, int(np.random.default_rng(r).choice([5, 6, 8])), seed=r)
        except RuntimeError:
            continue
        t0 = time.perf_counter()
        matches = eng.match(q)
        lat.append(time.perf_counter() - t0)
        if r % 10 == 0:
            if set(matches) != set(vf2_match(g, q)):
                raise AssertionError(f"request {r}: the match set differs from VF2's")
            checked += 1
    ms = np.sort(np.asarray(lat)) * 1e3
    print(f"[serve] {len(lat)} queries: p50 {ms[len(ms) // 2]:.1f}ms "
          f"p95 {ms[int(len(ms) * 0.95)]:.1f}ms  throughput {len(lat) / sum(lat):.1f} qps; "
          f"{checked} checked against VF2")
    return {"queries": len(lat), "checked": checked}


def serve_lm(args, dev) -> dict:
    from ..configs import get_arch, init_params, resolve_config
    from ..serve import DecodeEngine, ServeConfig

    arch = get_arch(args.arch)
    cfg = resolve_config(arch, arch.shapes[0], smoke=True)
    params = init_params(arch, cfg, seed=0, device=dev)
    eng = DecodeEngine(params, cfg, ServeConfig(max_batch=4, max_len=128, eos_token=-1),
                       device=dev)
    rng = np.random.default_rng(0)
    rids = [eng.submit(list(rng.integers(2, cfg.vocab, 8)), max_new=16)
            for _ in range(args.requests)]
    t0 = time.perf_counter()
    out = eng.run_until_drained()
    dt = time.perf_counter() - t0
    toks = sum(len(v) for v in out.values())
    print(f"[serve] {arch.name} on {dev}: {len(out)}/{len(rids)} requests, {toks} tokens in "
          f"{dt:.1f}s ({toks / dt:.1f} tok/s, continuous batching over 4 slots)")
    return {"finished": out, "tokens": toks}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["gnnpe", "lm"], default="gnnpe")
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--encoder", default="monotone")
    ap.add_argument("--quantize", action="store_true")
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    return serve_gnnpe(args, dev) if args.mode == "gnnpe" else serve_lm(args, dev)


if __name__ == "__main__":
    main()
