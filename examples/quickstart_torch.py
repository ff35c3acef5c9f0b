"""Quickstart on the PyTorch port: build a GNN-PE index offline, answer
exact subgraph queries, each held against VF2 (the port's counterpart of
``examples/quickstart.py``: the same graph, config and checks).

The engine runs on the card (``--device cuda``, the default) and exits
with an error where there is none; ``--device cpu`` runs it on the CPU
with the kernels' plain versions.  ``--encoder monotone`` builds with the
constructive encoder (the same guarantee, no training: the GAT's 150
epochs take about 90 s on a CPU).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu] [--encoder monotone]
"""
import argparse

from repro_torch.core import GnnPeConfig, GnnPeEngine, TrainConfig, vf2_match
from repro_torch.graphs import newman_watts_strogatz, random_connected_query


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs: the card (default) or 'cpu'")
    ap.add_argument("--encoder", default="gat", choices=["gat", "monotone"],
                    help="the paper's trained GAT (default) or the constructive encoder")
    args = ap.parse_args()

    # 1. a labeled data graph (paper §6.1 synthetic generator)
    g = newman_watts_strogatz(500, k=4, p=0.1, n_labels=20, seed=0)
    print(f"data graph: |V|={g.n_vertices} |E|={g.n_edges} labels={g.labels.max()+1}")

    # 2. offline phase (Alg. 1 lines 1-5): partition → dominance GNNs →
    #    path embeddings → packed block indexes; encoder="gat" is the paper's
    #    model (trained to zero hinge loss)
    cfg = GnnPeConfig(
        path_length=2, emb_dim=2, n_multi=1, n_partitions=2,
        encoder=args.encoder, train=TrainConfig(max_epochs=150),
    )
    engine = GnnPeEngine(cfg, device=args.device).build(g)
    st = engine.offline_stats
    print(
        f"offline on {args.device}: {st['total_time']:.1f}s (train {st['train_time']:.1f}s) "
        f"{st['n_paths']} paths indexed, edge cut {st['edge_cut']}"
    )

    # 3. online phase (Alg. 3): exact matching with pruning stats
    for seed in range(3):
        q = random_connected_query(g, 6, seed=seed)
        matches, stats = engine.match(q, return_stats=True)
        oracle = vf2_match(g, q)
        if set(matches) != set(oracle):
            raise SystemExit(f"query {seed}: GNN-PE's matches differ from VF2's")
        print(
            f"query {seed}: |V(q)|={q.n_vertices} → {len(matches)} matches "
            f"(oracle agrees), pruning power {stats.pruning_power:.4f}, "
            f"filter {stats.filter_time*1e3:.1f}ms join {stats.join_time*1e3:.1f}ms, "
            f"plan={stats.plan.n_paths} paths [{stats.plan.strategy}]"
        )


if __name__ == "__main__":
    main()
