"""The port's partition-parallel GNN (``models/gnn_partition.py``): the
halo-exchange metadata built array for array as the JAX package's, and the
partition loss in 8 gloo processes, one rank a shard, as the reference's
``tests/test_partition_parallel.py`` runs it on 8 host devices.  Its loss
and its gradients summed over the ranks equal the port's dense full-graph
path (loss within 2e-4, every gradient within 5e-4, the reference test's
limits) and the reference's dense loss; one partition-parallel
``build_step`` train step equals the dense step's params within 1e-6."""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.graphs import erdos_renyi as j_er  # noqa: E402
from repro.graphs import partition_graph as j_partition  # noqa: E402
from repro.models import GNNConfig as JConfig  # noqa: E402
from repro.models import gnn_node_loss as j_loss  # noqa: E402
from repro.models import init_gnn_params as j_init  # noqa: E402
from repro.models.gnn_partition import build_partition_batch as j_build  # noqa: E402
from repro_torch.convert import gnn_params_from_reference  # noqa: E402
from repro_torch.graphs import erdos_renyi, partition_graph  # noqa: E402
from repro_torch.models import GNNConfig, build_partition_batch, gnn_node_loss  # noqa: E402
from repro_torch.train import OptConfig, adamw_init, tree_leaves, value_and_grad  # noqa: E402
from repro_torch.train.step import train_wrap  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
N_SHARDS = 8

WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs import build_step, get_arch
from repro_torch.graphs import erdos_renyi, partition_graph
from repro_torch.models import GNNConfig, build_partition_batch, init_gnn_params, partition_gnn_loss
from repro_torch.train import OptConfig, adamw_init, tree_leaves, tree_unflatten, value_and_grad

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=8, rank=rank)
g = erdos_renyi(240, avg_degree=5, n_labels=3, seed=0)
rng = np.random.default_rng(0)
feat = rng.normal(size=(g.n_vertices, 12)).astype(np.float32)
labels = rng.integers(0, 4, g.n_vertices).astype(np.int32)
full = build_partition_batch(g, feat, labels, partition_graph(g, 8, seed=0), 8)
shard = {k: torch.from_numpy(v[rank:rank + 1]) for k, v in full.items()}
for kind in ("gin", "sage"):
    cfg = GNNConfig(kind=kind, n_layers=2, d_hidden=16, d_in=12, n_classes=4,
                    partition_parallel=True, n_shards=8)
    saved = np.load(f"{out}/params_{kind}.npz")
    tree = init_gnn_params(torch.Generator().manual_seed(0), cfg)
    params = tree_unflatten(tree, [torch.from_numpy(saved[f"arr_{i}"])
                                   for i in range(len(tree_leaves(tree)))])
    (loss, _), grads = value_and_grad(lambda p, b: partition_gnn_loss(p, cfg, b), params, shard)
    from repro_torch.models import sum_over_ranks
    grads = sum_over_ranks(grads)
    arch = get_arch("gin-tu" if kind == "gin" else "graphsage-reddit")
    step, _ = build_step(arch, arch.cell("ogb_products"), cfg,
                         OptConfig(lr=1e-2, warmup_steps=0, total_steps=10))
    new, _, met = step(params, adamw_init(params), shard)
    if rank == 0:
        np.savez(f"{out}/got_{kind}.npz", loss=loss.numpy(), step_loss=met["loss"].numpy(),
                 *[x.numpy() for x in tree_leaves(grads)] + [x.numpy() for x in tree_leaves(new)])
dist.barrier()
dist.destroy_process_group()
print("ok")
"""


def _setup():
    g = erdos_renyi(240, avg_degree=5, n_labels=3, seed=0)
    rng = np.random.default_rng(0)
    feat = rng.normal(size=(g.n_vertices, 12)).astype(np.float32)
    labels = rng.integers(0, 4, g.n_vertices).astype(np.int32)
    return g, feat, labels


def test_build_partition_batch_identical_to_the_reference():
    g, feat, labels = _setup()
    jg = j_er(240, avg_degree=5, n_labels=3, seed=0)
    part, jpart = partition_graph(g, N_SHARDS, seed=0), j_partition(jg, N_SHARDS, seed=0)
    assert np.array_equal(part.assignment, jpart.assignment)
    got = build_partition_batch(g, feat, labels, part, N_SHARDS)
    want = j_build(jg, feat, labels, jpart, N_SHARDS)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_partition_loss_in_8_gloo_processes_equals_the_dense_path(tmp_path):
    g, feat, labels = _setup()
    e = g.edge_array()
    both = np.concatenate([e, e[:, ::-1]], 0).astype(np.int32)
    dense = {"node_feat": feat, "edge_index": both, "labels": labels}
    tdense = {k: torch.from_numpy(v) for k, v in dense.items()}
    refs = {}
    for kind in ("gin", "sage"):
        cfg = JConfig(kind=kind, n_layers=2, d_hidden=16, d_in=12, n_classes=4,
                      partition_parallel=True, n_shards=N_SHARDS)
        jp = j_init(jax.random.PRNGKey(1), cfg)
        np.savez(tmp_path / f"params_{kind}.npz", *[np.asarray(x) for x in jax.tree.leaves(jp)])
        refs[kind] = (jp, float(j_loss(jp, cfg, dense)[0]))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(port), str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(N_SHARDS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=150))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0 and so.strip().endswith("ok"), se[-3000:]
    for kind in ("gin", "sage"):
        jp, jloss = refs[kind]
        cfg = GNNConfig(kind=kind, n_layers=2, d_hidden=16, d_in=12, n_classes=4)
        tp = gnn_params_from_reference(jp, device="cpu")
        (loss, _), grads = value_and_grad(lambda p, b: gnn_node_loss(p, cfg, b), tp, tdense)
        step = train_wrap(lambda p, b: gnn_node_loss(p, cfg, b),
                          OptConfig(lr=1e-2, warmup_steps=0, total_steps=10))
        new, _, met = step(tp, adamw_init(tp), tdense)
        got = np.load(tmp_path / f"got_{kind}.npz")
        assert abs(float(got["loss"]) - float(loss)) < 2e-4, kind
        assert abs(float(got["loss"]) - jloss) < 2e-4, kind
        assert abs(float(got["step_loss"]) - float(met["loss"])) < 2e-4, kind
        n = len(tree_leaves(grads))
        for i, want in enumerate(tree_leaves(grads)):
            assert np.abs(got[f"arr_{i}"] - want.numpy()).max() < 5e-4, (kind, i)
        for i, want in enumerate(tree_leaves(new)):
            w = want.numpy()
            assert np.abs(got[f"arr_{n + i}"] - w).max() <= 1e-6 * (1 + np.abs(w).max()), (kind, i)
