"""GNN architecture zoo of the port: SchNet, GraphSAGE, MACE (Cartesian, l ≤ 2), GIN.

The JAX package's ``models/gnn.py`` as plain functions over dicts of
tensors, with the same params tree and the same three input regimes:

  * full graph:  an (E, 2) directed edge index over all N nodes
                 (``full_graph_sm``, ``ogb_products``);
  * ELL blocks:  padded fanout samples from ``graphs/sampler.py`` (``minibatch_lg``);
  * molecules:   (B, M)-padded batches flattened into one disjoint graph.

MACE is the reference's adaptation: Cartesian equivariant moments up to
l = 2 (a vector and a traceless rank-2 tensor a channel) contracted into
correlation-order-3 invariants, so its outputs are E(3)-invariant.

Memory at ``ogb_products`` (2.45 M nodes, 123.7 M directed edges): a
gathered (E, H) message alone is 31.7 GB at H = 64, SchNet's (E, 300)
radial basis 148 GB and MACE's (E, 3, 3, H) moment 570 GB.  So no (E, ·)
tensor outlives one chunk of edges:

  * the full-graph forward sorts the edges by destination once (this
    changes only the order of each node's sum), so a range of destination
    rows owns a contiguous range of edges, summed row by row in order
    (``segment_reduce``, no atomics);
  * gin and sage aggregate through ``segment_sum``, one
    ``autograd.Function`` that gathers with ``index_select`` and sums a
    row range's edges at a time, its backward an ``index_add_`` into the
    source rows, and saves only the indices;
  * schnet and mace run each layer one row range at a time, each range one
    non-reentrant ``torch.utils.checkpoint`` segment that reads the layer's
    input and writes only its own rows, so its per-edge tensors are
    recomputed in the backward instead of kept.

On the card the backward's ``index_add_`` sums with atomics, so gradients
are held to a tolerance there, not to bits.

On DTensors (the dry-run's production mesh: nodes and edges split over the
data axes) the full-graph forward adds each rank's edges into partial node
sums reduced into the nodes' placement (``_edge_sums``), and the sampled
blocks' row gathers and the molecule readout run per rank
(``_gather_rows``, ``_scatter_sum``), all on each rank's blocks, as the JAX
package's plan of ``segment_sum`` runs; each gather and reduction is one
collective over the data axes as one group (pod × data at once, uneven
splits included), not one a mesh dim.  Plain tensors take the paths above.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..dist import collectives as coll
from ..dist.context import group_over, is_dtensor, on_blocks, row_blocks, row_split_dims
from .common import dense_init

__all__ = [
    "GNNConfig",
    "init_gnn_params",
    "segment_sum",
    "gnn_forward_full",
    "gnn_forward_blocks",
    "gnn_node_loss",
    "gnn_blocks_loss",
    "gnn_energy_loss",
    "CHUNK_ELEMENTS",
]

# elements of the largest per-edge temporary of one edge chunk (2 GiB of float32)
CHUNK_ELEMENTS = 1 << 29


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    kind: str = "gin"  # gin | sage | schnet | mace
    n_layers: int = 2
    d_hidden: int = 64
    d_in: int = 16
    n_classes: int = 8
    # schnet
    n_rbf: int = 300
    cutoff: float = 10.0
    # mace
    l_max: int = 2
    correlation: int = 3
    mace_n_rbf: int = 8
    # sage
    aggregator: str = "mean"
    dtype: Any = "float32"
    # partition-parallel full-graph training with a halo exchange (models/gnn_partition.py)
    partition_parallel: bool = False
    n_shards: int = 16
    boundary_frac: float = 0.05

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def _mlp_init(generator: torch.Generator, dims) -> list:
    dev = generator.device
    return [
        {"w": dense_init(generator, (dims[i], dims[i + 1])),
         "b": torch.zeros(dims[i + 1], device=dev)}
        for i in range(len(dims) - 1)
    ]


def _mlp_apply(layers, x, act=torch.relu, final_act=False):
    for i, lyr in enumerate(layers):
        x = x @ lyr["w"].to(x.dtype) + lyr["b"].to(x.dtype)
        if i < len(layers) - 1 or final_act:
            x = act(x)
    return x


def init_gnn_params(generator: torch.Generator, cfg: GNNConfig) -> dict:
    """Random params on ``generator``'s device, the JAX package's tree:
    ``encode`` and ``readout`` MLPs (lists of ``{"w", "b"}``) and one dict
    a layer (gin: ``mlp``, ``eps`` a 0-d tensor; sage: ``w_self``,
    ``w_nbr``, ``b``; schnet: ``filter``, ``dense1``, ``dense2``, ``b1``,
    ``b2``; mace: ``radial``, ``mix``).  Fan-in truncated normals drawn in
    tree order; the same distribution as the reference's, not its numbers."""
    H = cfg.d_hidden
    dev = generator.device
    p: dict = {"encode": _mlp_init(generator, [cfg.d_in, H])}
    layers = []
    for _ in range(cfg.n_layers):
        if cfg.kind == "gin":
            layers.append({"mlp": _mlp_init(generator, [H, H, H]),
                           "eps": torch.zeros((), device=dev)})
        elif cfg.kind == "sage":
            layers.append({"w_self": dense_init(generator, (H, H)),
                           "w_nbr": dense_init(generator, (H, H)),
                           "b": torch.zeros(H, device=dev)})
        elif cfg.kind == "schnet":
            layers.append({
                "filter": _mlp_init(generator, [cfg.n_rbf, H, H]),
                "dense1": dense_init(generator, (H, H)),
                "dense2": dense_init(generator, (H, H)),
                "b1": torch.zeros(H, device=dev),
                "b2": torch.zeros(H, device=dev),
            })
        elif cfg.kind == "mace":
            n_inv = 5  # A0, |A1|², A2:A2, A1·A2·A1, A0³ (the correlation-3 set)
            layers.append({"radial": _mlp_init(generator, [cfg.mace_n_rbf, H, 3 * H]),
                           "mix": _mlp_init(generator, [n_inv * H, H, H])})
        else:
            raise ValueError(cfg.kind)
    p["layers"] = layers
    p["readout"] = _mlp_init(generator, [H, cfg.n_classes])
    return p


# ----------------------------------------------------------- basis fns ----


def _envelope(d, cutoff):
    return 0.5 * (torch.cos(math.pi * torch.clamp(d / cutoff, 0, 1)) + 1.0)


def _rbf(d, n_rbf, cutoff):
    """Gaussian radial basis (SchNet) with a cosine cutoff envelope."""
    centers = torch.linspace(0.0, cutoff, n_rbf, dtype=d.dtype, device=d.device)
    gamma = n_rbf / cutoff
    return torch.exp(-gamma * (d[..., None] - centers) ** 2) * _envelope(d, cutoff)[..., None]


def _bessel(d, n_rbf, cutoff):
    """Bessel radial basis (MACE/NequIP)."""
    n = torch.arange(1, n_rbf + 1, dtype=d.dtype, device=d.device)
    x = torch.clamp(d, min=1e-6)
    return (torch.sin(n * math.pi * x[..., None] / cutoff) / x[..., None]) * _envelope(d, cutoff)[..., None]


def _ssp(x):  # shifted softplus (SchNet's activation)
    return F.softplus(x) - np.log(2.0)


# --------------------------------------------------------- aggregation ----


@dataclasses.dataclass(frozen=True)
class _Edges:
    """A directed edge set sorted by destination: int64 ``src`` and ``dst``,
    ``n`` destination rows, ``counts`` (n,) each row's edges on the device,
    and ``ptr`` (n + 1,) the host CSR offsets of each row's edges."""

    src: torch.Tensor
    dst: torch.Tensor
    n: int
    counts: torch.Tensor
    ptr: np.ndarray

    def ranges(self, chunk: int) -> list:
        """Consecutive row ranges [r0, r1) each holding at most ``chunk`` edges
        (a single row with more is a range of its own) → [(r0, r1, e0, e1)]."""
        ptr, out, r0 = self.ptr, [], 0
        while r0 < self.n:
            r1 = int(np.searchsorted(ptr, ptr[r0] + chunk, side="right")) - 1
            r1 = min(max(r1, r0 + 1), self.n)
            out.append((r0, r1, int(ptr[r0]), int(ptr[r1])))
            r0 = r1
        return out


def _sorted_edges(edge_index, n: int) -> _Edges:
    """(E, 2) (src, dst) → the edges stably sorted by destination."""
    dst, order = torch.sort(edge_index[:, 1].long(), stable=True)
    src = edge_index[:, 0].long().index_select(0, order)
    counts = torch.bincount(dst, minlength=n)
    ptr = np.zeros(n + 1, np.int64)
    ptr[1:] = np.cumsum(counts.cpu().numpy())
    return _Edges(src, dst, n, counts, ptr)


def _rows_sum(msg, counts):
    """Each row's consecutive ``counts`` entries of ``msg`` summed in order
    (no atomics: the edges are sorted by destination)."""
    return torch.segment_reduce(msg, "sum", lengths=counts, axis=0, unsafe=True)


class _SegmentSum(torch.autograd.Function):
    """``out[dst[e]] += h[src[e]]`` over every edge, one row range at a time:
    forward a gather and an in-order row sum, backward a gather of the rows'
    gradients and an ``index_add_`` into ``src``'s rows."""

    @staticmethod
    def forward(ctx, h, edges, chunk):
        out = h.new_empty((edges.n,) + tuple(h.shape[1:]))
        ranges = edges.ranges(chunk)
        for r0, r1, e0, e1 in ranges:
            out[r0:r1] = _rows_sum(h.index_select(0, edges.src[e0:e1]), edges.counts[r0:r1])
        ctx.edges, ctx.ranges, ctx.n_in = edges, ranges, h.shape[0]
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        src, dst = ctx.edges.src, ctx.edges.dst
        gh = grad.new_zeros((ctx.n_in,) + tuple(grad.shape[1:]))
        for _, _, e0, e1 in ctx.ranges:
            gh.index_add_(0, src[e0:e1], grad.index_select(0, dst[e0:e1]))
        return gh, None, None


def segment_sum(h, src, dst, n_out: int, chunk: int | None = None):
    """(n_out, ...) sums of ``h``'s rows ``src[e]`` into rows ``dst[e]``
    (int indices), ``chunk`` edges at a time (all at once by default): the
    edges are sorted by destination and summed row by row; the gathered
    (E, ...) rows never exist whole, forward or backward."""
    edges = _sorted_edges(torch.stack([src, dst], dim=1), int(n_out))
    return _SegmentSum.apply(h, edges, int(chunk or max(src.shape[0], 1)))


def _aggregate(h, edges: _Edges, how: str, chunk: int):
    s = _SegmentSum.apply(h, edges, chunk)
    if how == "sum":
        return s
    if how == "mean":
        return s / torch.clamp(edges.counts.to(s.dtype), min=1.0)[:, None]
    raise ValueError(how)


def _edge_chunk(cfg: GNNConfig, chunk: int | None) -> int:
    """Edges a chunk: ``chunk``, else as many as keep the kind's per-edge
    temporaries (``width`` floats an edge) within ``CHUNK_ELEMENTS``."""
    if chunk is not None:
        return max(int(chunk), 1)
    H = cfg.d_hidden
    width = {"gin": H, "sage": H, "schnet": cfg.n_rbf + 4 * H, "mace": 16 * H}[cfg.kind]
    return max(CHUNK_ELEMENTS // width, 1)


# ------------------------------------------------------------- layers -----


def _gin_update(p, h, nbr):
    return _mlp_apply(p["mlp"], (1.0 + p["eps"]) * h + nbr)


def _sage_update(p, h, nbr):
    out = h @ p["w_self"].to(h.dtype) + nbr @ p["w_nbr"].to(h.dtype) + p["b"].to(h.dtype)
    return torch.relu(out)


def _gin_layer(p, h, edges, cfg, chunk):
    return _gin_update(p, h, _aggregate(h, edges, "sum", chunk))


def _sage_layer(p, h, edges, cfg, chunk):
    return _sage_update(p, h, _aggregate(h, edges, cfg.aggregator, chunk))


def _geometry(pos, src, dst, dtype):
    vec = (pos.index_select(0, src) - pos.index_select(0, dst)).to(dtype)
    return vec, torch.linalg.vector_norm(vec, dim=-1)


def _schnet_messages(p, h, pos, src, dst, cfg):
    """SchNet's per-edge message (cfconv: the filter × the neighbor's
    features), one a destination sum."""
    _, dist = _geometry(pos, src, dst, h.dtype)
    w = _mlp_apply(p["filter"], _rbf(dist, cfg.n_rbf, cfg.cutoff).to(h.dtype), act=_ssp,
                   final_act=True)
    yield h.index_select(0, src) * w


def _schnet_update(p, h, aggs):
    out = _ssp(aggs[0] @ p["dense1"].to(h.dtype) + p["b1"].to(h.dtype))
    return h + out @ p["dense2"].to(h.dtype) + p["b2"].to(h.dtype)


def _schnet_rows(p, h, pos, src, dst, counts, r0: int, r1: int, cfg):
    """SchNet's interaction block for destination rows [r0, r1) from their
    edges (``counts`` of them a row, in order)."""
    aggs = [_rows_sum(m, counts) for m in _schnet_messages(p, h, pos, src, dst, cfg)]
    return _schnet_update(p, h[r0:r1], aggs)


def _mace_messages(p, h, pos, src, dst, cfg):
    """The Cartesian ACE layer's per-edge l = 0, 1, 2 equivariant moments
    (n, H), (n, 3, H), (n, 3, 3, H), one destination sum each, made one at
    a time."""
    H = h.shape[-1]
    vec, dist = _geometry(pos, src, dst, h.dtype)
    rhat = vec / torch.clamp(dist[:, None], min=1e-6)
    radial = _mlp_apply(p["radial"], _bessel(dist, cfg.mace_n_rbf, cfg.cutoff).to(h.dtype))
    R0, R1, R2 = radial[:, :H], radial[:, H:2 * H], radial[:, 2 * H:]
    hj = h.index_select(0, src)
    yield R0 * hj
    yield (R1 * hj)[:, None, :] * rhat[:, :, None]
    outer = rhat[:, :, None] * rhat[:, None, :] - torch.eye(3, dtype=h.dtype, device=h.device) / 3.0
    yield (R2 * hj)[:, None, None, :] * outer[..., None]


def _mace_update(p, h, aggs):
    """Correlation-order-3 invariants of the moments' sums, mixed into h."""
    A0, A1, A2 = aggs
    # invariant contractions, correlation order up to 3, as elementwise sums over
    # the 3 × 3 Cartesian axes (an einsum here runs as many small GEMVs)
    B1 = torch.sum(A1 * A1, dim=1)
    B2 = torch.sum(A2 * A2, dim=(1, 2))
    B3 = torch.sum(A1[:, :, None, :] * A2 * A1[:, None, :, :], dim=(1, 2))  # order-3 coupling
    B4 = A0 * A0 * A0
    inv = torch.cat([A0, B1, B2, B3, B4], dim=-1)
    return h + _mlp_apply(p["mix"], inv)


def _mace_rows(p, h, pos, src, dst, counts, r0: int, r1: int, cfg):
    """The Cartesian ACE layer (l ≤ 2, correlation order 3) for rows [r0, r1)."""
    aggs = [_rows_sum(m, counts) for m in _mace_messages(p, h, pos, src, dst, cfg)]
    return _mace_update(p, h[r0:r1], aggs)


def _by_rows(fn, p, h, pos, edges: _Edges, cfg, chunk: int):
    """``fn``'s layer over every destination row, one checkpointed row range
    (at most ``chunk`` edges) at a time."""
    outs = []
    for r0, r1, e0, e1 in edges.ranges(chunk):
        args = (p, h, pos, edges.src[e0:e1], edges.dst[e0:e1], edges.counts[r0:r1], r0, r1, cfg)
        if torch.is_grad_enabled():
            outs.append(checkpoint(fn, *args, use_reentrant=False))
        else:
            outs.append(fn(*args))
    return torch.cat(outs) if len(outs) > 1 else outs[0]


# ------------------------------------------------------- on DTensors ----


def _gin_messages(p, h, pos, src, dst, cfg):
    yield h.index_select(0, src)


def _ones_messages(p, h, pos, src, dst, cfg):
    yield h.new_ones((src.shape[0], 1))


def _rows_placement(mesh, dims) -> list:
    """Rows split by ``Shard(0)`` over mesh dims ``dims``, whole on the rest."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if i in dims else Replicate() for i in range(mesh.ndim)]


def _same_split(a, b, what: str) -> list:
    """The mesh dims that split both ``a``'s and ``b``'s rows (DTensors on one
    mesh); they must be the same dims."""
    da, db = row_split_dims(a), row_split_dims(b)
    if da != db:
        raise ValueError(f"{what}: rows split over mesh dims {da} and {db}; the GNN's DTensor "
                         "path takes both split over the same (configs.input_pspecs: DP)")
    return da


def _whole_rows(x, mesh, dims, n: int):
    """On a rank's block: the whole (n, …) from this rank's block of rows
    split over ``dims``, one all-gather over them as one group (pod × data
    at once); the backward one reduce-scatter."""
    group = group_over(mesh, dims)
    return x if group is None else coll.gather_blocks(x, group, row_blocks(n, mesh, dims))


def _own_rows(x, mesh, dims, n: int):
    """On a rank's block: this rank's block of rows (split over ``dims``)
    of Σ over those ranks of its partial (n, …) ``x``, one reduce-scatter
    over them as one group; the backward one all-gather."""
    group = group_over(mesh, dims)
    return x if group is None else coll.reduce_scatter_blocks(x, group, row_blocks(n, mesh, dims))


def _edge_sums(messages, n_sums: int, p, h, pos, edge_index, cfg, chunk: int) -> list:
    """Σ over the edges (src, dst) of ``messages(p, h, pos, src, dst, cfg)``
    (``n_sums`` of them) into rows ``dst`` → one (N, …) DTensor a message,
    placed as ``h``'s rows.  ``edge_index`` (E, 2) and h's nodes (and
    ``pos``'s, if given) split over the same mesh dims: each rank, on its
    blocks, gathers h whole, adds its edges' messages into partial (N, …)
    sums, ``chunk`` edges at a time (each chunk's sums checkpointed under
    autograd, as the card's row ranges are, so its per-edge tensors are
    recomputed in the backward; where the messages are rows of h, the
    gather and the sums checkpointed as a whole too, so the backward
    gathers h again), and reduces the sums into its own nodes.
    The gather and the reduction are one collective each over the split
    dims as one group (pod × data at once, DTensor's one a dim), uneven
    splits included.  Nothing is read back to the host.  ``p`` (the layer's
    params, replicated) may be None."""
    from torch.distributed.tensor import Partial, Replicate

    from ..train.functional import tree_leaves, tree_unflatten

    mesh = h.device_mesh
    split = _same_split(edge_index, h, "edge sums")
    nodes = _rows_placement(mesh, split)
    whole = [Replicate()] * mesh.ndim
    partial = [Partial() if i in split else Replicate() for i in range(mesh.ndim)]
    edges = [q if i in split else Replicate() for i, q in enumerate(edge_index.placements)]
    leaves = tree_leaves(p) if p is not None else []
    dense = [h] + ([pos] if pos is not None else [])
    n = h.shape[0]

    def part(src, dst, *rest):
        hh, pp = rest[0], (rest[1] if pos is not None else None)
        lv = rest[len(dense):]
        msgs = messages(tree_unflatten(p, iter(lv)) if p is not None else None, hh, pp, src, dst,
                        cfg)
        return tuple(m.new_zeros((n,) + tuple(m.shape[1:])).index_add(0, dst, m) for m in msgs)

    def partial_sums(ei, *rest):
        rest = tuple(_whole_rows(t, mesh, split, n) for t in rest[:len(dense)]) + rest[len(dense):]
        accs = None
        for e0 in range(0, max(ei.shape[0], 1), chunk):
            src, dst = ei[e0:e0 + chunk, 0].long(), ei[e0:e0 + chunk, 1].long()
            if torch.is_grad_enabled():
                sums = checkpoint(part, src, dst, *rest, use_reentrant=False)
            else:
                sums = part(src, dst, *rest)
            accs = sums if accs is None else tuple(a + b for a, b in zip(accs, sums))
        return accs

    def body(ei, *rest):
        # messages that are rows of h (gin, sage: no params, no per-edge work): the gather and
        # the sums are checkpointed as a whole too, so that a layer keeps its own rows until the
        # backward, which gathers them again, not the gathered (N, …) ones; schnet's and mace's
        # messages compute per edge, and redoing that once more would cost flops (schnet's RBF
        # MLP) or memory (mace's three wide sums at once)
        if torch.is_grad_enabled() and p is None:
            accs = checkpoint(partial_sums, ei, *rest, use_reentrant=False)
        else:
            accs = partial_sums(ei, *rest)
        return tuple(_own_rows(a, mesh, split, n) for a in accs)

    out = on_blocks(body, mesh, [(edge_index, edges, edges)] + [(t, nodes, nodes) for t in dense]
                    + [(t, whole, partial) for t in leaves], [(nodes, n)] * n_sums)
    return [a.redistribute(mesh, h.placements) for a in out]


def _gather_rows(h, idx):
    """``h``'s rows at ``idx`` (int, any shape) → (*idx.shape, *h.shape[1:]).
    On DTensors (h's rows and ``idx``'s dim 0 split over the same mesh
    dims): each rank gathers h whole, one all-gather over
    those dims as one group, and takes its own indices' rows (the JAX
    package's gather, whose rule DTensor lacks on some versions); the output
    split as ``idx``, h's gradient one reduce-scatter of the ranks' shares."""
    if not is_dtensor(idx):
        return h.index_select(0, idx.reshape(-1).long()).reshape(tuple(idx.shape) +
                                                                  tuple(h.shape[1:]))
    from torch.distributed.tensor import Replicate

    mesh = idx.device_mesh
    split = _same_split(idx, h, "row gather")
    own = [q if i in split else Replicate() for i, q in enumerate(idx.placements)]
    rows = _rows_placement(mesh, split)
    n = h.shape[0]
    return on_blocks(lambda hh, i: _gather_rows(_whole_rows(hh, mesh, split, n), i), mesh,
                     [(h, rows, rows), (idx, own, own)], [(own, idx.shape[0])])[0]


def _scatter_sum(values, idx, n_out: int, like):
    """(n_out,) Σ of ``values`` into rows ``idx`` (both (M,)).  On DTensors
    each rank adds its own entries into a partial sum,
    reduced into ``like``'s rows (split over the mesh dims that split
    ``idx``) by one reduce-scatter over those dims as one group."""
    if not is_dtensor(idx):
        return values.new_zeros(n_out).index_add(0, idx.long(), values)
    from torch.distributed.tensor import Replicate

    mesh = idx.device_mesh
    split = _same_split(idx, like, "scatter sum")
    own = [q if i in split else Replicate() for i, q in enumerate(idx.placements)]
    out = on_blocks(lambda v, i: _own_rows(v.new_zeros(n_out).index_add(0, i.long(), v), mesh,
                                           split, n_out), mesh,
                    [(values, own, own), (idx, own, own)], [(_rows_placement(mesh, split), n_out)])
    return out[0].redistribute(mesh, like.placements)


def _forward_full_on_dtensors(params, cfg: GNNConfig, h, edge_index, positions, chunk: int):
    """The layers of ``gnn_forward_full`` on DTensors (nodes and edges split
    over the data axes, as ``configs.input_pspecs`` places them): each
    layer's edge sums through ``_edge_sums``, its node update as on the
    card."""
    kinds = {"gin": (_gin_messages, 1, _gin_update), "sage": (_gin_messages, 1, _sage_update),
             "schnet": (_schnet_messages, 1, _schnet_update),
             "mace": (_mace_messages, 3, _mace_update)}
    messages, n_sums, update = kinds[cfg.kind]
    counts = None
    if cfg.kind == "sage" and cfg.aggregator == "mean":
        counts = _edge_sums(_ones_messages, 1, None, h, None, edge_index, cfg, chunk)[0]
    geometric = cfg.kind in ("schnet", "mace")  # their messages read the layer and the positions
    for p in params["layers"]:
        aggs = _edge_sums(messages, n_sums, p if geometric else None, h,
                          positions if geometric else None, edge_index, cfg, chunk)
        if cfg.kind in ("gin", "sage"):
            nbr = aggs[0] if counts is None else aggs[0] / torch.clamp(counts, min=1.0)
            h = update(p, h, nbr)
        else:
            h = update(p, h, aggs)
    return h


# ------------------------------------------------------------- drivers ----


def gnn_forward_full(params, cfg: GNNConfig, node_feat, edge_index, positions=None,
                     n_nodes=None, edge_chunk: int | None = None):
    """Full-graph forward → (N, n_classes).  node_feat (N, d_in); edge_index
    (E, 2) directed (src, dst).  schnet and mace need ``positions`` (N, 3).
    ``edge_chunk``: edges a chunk (default: ``_edge_chunk``'s budget)."""
    dtype = cfg.compute_dtype
    h = _mlp_apply(params["encode"], node_feat.to(dtype))
    n = n_nodes or node_feat.shape[0]
    geometric = cfg.kind in ("schnet", "mace")
    if geometric and positions is None:
        raise ValueError(f"{cfg.kind} needs positions")
    chunk = _edge_chunk(cfg, edge_chunk)
    if is_dtensor(edge_index):
        h = _forward_full_on_dtensors(params, cfg, h, edge_index, positions, chunk)
        return _mlp_apply(params["readout"], h)
    edges = _sorted_edges(edge_index, n)
    for p in params["layers"]:
        if cfg.kind == "gin":
            h = _gin_layer(p, h, edges, cfg, chunk)
        elif cfg.kind == "sage":
            h = _sage_layer(p, h, edges, cfg, chunk)
        elif cfg.kind == "schnet":
            h = _by_rows(_schnet_rows, p, h, positions, edges, cfg, chunk)
        elif cfg.kind == "mace":
            h = _by_rows(_mace_rows, p, h, positions, edges, cfg, chunk)
    return _mlp_apply(params["readout"], h)


def gnn_forward_blocks(params, cfg: GNNConfig, feats, blocks):
    """Sampled-minibatch forward over ELL blocks (the GraphSAGE regime).

    feats: (N_outer, d_in) features of the outermost layer's vertex set;
    blocks: one dict a layer, outermost first: ``nbr_index`` (n_dst,
    fanout) int, ``mask`` (n_dst, fanout) bool and ``dst_index`` (n_dst,),
    the rows of the source set that are the destination vertices.  As the
    reference's ``zip``, only the first ``min(layers, blocks)`` layers run;
    schnet and mace fall back to ``relu(h_dst + agg)`` here, their params
    then unused."""
    dtype = cfg.compute_dtype
    h = _mlp_apply(params["encode"], feats.to(dtype))
    for p, blk in zip(params["layers"], blocks):
        nbr = _gather_rows(h, blk["nbr_index"])
        mask = blk["mask"][..., None].to(dtype)
        s = torch.sum(nbr * mask, dim=1)
        if cfg.kind == "sage" and cfg.aggregator == "mean":
            agg = s / torch.clamp(mask.sum(1), min=1.0)
        else:
            agg = s
        h_dst = _gather_rows(h, blk["dst_index"])
        if cfg.kind == "gin":
            h = _mlp_apply(p["mlp"], (1.0 + p["eps"]) * h_dst + agg)
        elif "w_self" in p:
            h = torch.relu(h_dst @ p["w_self"].to(dtype) + agg @ p["w_nbr"].to(dtype)
                           + p["b"].to(dtype))
        else:  # schnet / mace in the sampled regime: a dense mix
            h = torch.relu(h_dst + agg)
    return _mlp_apply(params["readout"], h)


# --------------------------------------------------------------- losses ----


def _nll(logits, labels):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, 1, labels.long()[:, None])[:, 0]


def gnn_node_loss(params, cfg: GNNConfig, batch):
    """Node-classification cross-entropy (full-graph shapes) → (loss, {})."""
    logits = gnn_forward_full(params, cfg, batch["node_feat"], batch["edge_index"],
                              batch.get("positions"))
    nll = _nll(logits, batch["labels"])
    mask = batch.get("train_mask")
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0), {}
    return torch.mean(nll), {}


def gnn_blocks_loss(params, cfg: GNNConfig, batch):
    """Mean cross-entropy of the seeds' logits over ELL blocks → (loss, {})."""
    logits = gnn_forward_blocks(params, cfg, batch["feats"], batch["blocks"])
    return torch.mean(_nll(logits, batch["labels"])), {}


def gnn_energy_loss(params, cfg: GNNConfig, batch):
    """Molecular energy regression (molecule shapes): the batch is one
    disjoint graph; a graph's energy is the masked sum of its nodes' first
    output → (mean squared error, {"energy_mae"})."""
    out = gnn_forward_full(params, cfg, batch["node_feat"], batch["edge_index"],
                           batch.get("positions"))
    target = batch["energy"]
    node_e = out[:, 0] * batch["node_mask"]
    energy = _scatter_sum(node_e, batch["graph_id"], target.shape[0], target)
    loss = torch.mean((energy - target) ** 2)
    return loss, {"energy_mae": torch.mean(torch.abs(energy - target)).detach()}
