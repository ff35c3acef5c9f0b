"""Mixture-of-Experts FFN on one card: the JAX package's ``models/moe.py``
with every expert local (its ``mesh=None`` branch).

Token-choice top-k routing over float32 gates, a capacity per expert over
the whole batch of T tokens, GShard-style dropping past it, the expert FFNs
as batched products over an (E, C, D) buffer, and the DeepSeek-style
shared experts, a dense SwiGLU over every token.  The router is float32
whatever the other params' dtype, as the reference creates and applies it.

Dropping is the reference's exactly: the (token, expert) entries sorted
by expert with a stable sort, each one's rank within its expert the
distance to the expert's first entry (a left ``searchsorted``), entries of
rank ≥ capacity dropped.  The reference scatters a dropped entry's zeros
into slot ``cap − 1`` of expert 0 with an accumulating scatter, which
leaves that slot as it was; here each kept entry writes its own slot of
the buffer and the dropped ones a spare row past it (no accumulating
scatter: PyTorch sorts for one), so the buffer is the reference's.  A
dropped entry gets weight 0.  The combine adds up to K weighted expert
outputs a token in the compute dtype; on the card ``index_add_`` does that
with atomics, so its bf16 rounding order varies from run to run.

Expert parallelism (``mesh=``, the reference's ``shard_map`` branch) runs
over a mesh of processes (a ``DeviceMesh`` with a ``model`` dim of more
than one rank, or with ``fsdp`` a ``data`` dim of more than one), each
rank with its own block of every tensor:

  * the tokens it sees, ``x2d``: its block of the data axes' split
    (``moe_token_spec`` gives the reference's rule: the tokens replicated
    where their count does not split over the data axes);
  * the experts ``[e_start, e_start + E/n)`` of its ``model`` coordinate,
    and with ``fsdp`` their dim 1 (D of w1 and w3, F of w2) split over
    ``data`` as well (``dist.sharding.lm_param_specs``), all-gathered in
    the compute dtype just in time; the router and the shared experts whole.

Each rank routes its tokens over every expert, at a capacity of the tokens
it sees (per data shard, as the reference), dispatches those routed to its
own experts, and one sum over ``model`` combines the partial outputs
(``dist.collectives.sum_over``: its backward passes the gradient through,
as ``psum``'s transpose does).  The tokens enter the split work through
``copy_to`` (identity forward, a sum over ``model`` backward), so their
gradient is whole on every rank; the shared experts run outside the split,
on every token.  ``aux`` is the sum over ``model`` of each rank's aux over
``n``: the aux of this rank's tokens, its gradient split over the ranks.

The gradients a rank's backward leaves are its own shares:
``moe_grad_sync`` sums each leaf over exactly the ranks whose shares
differ (every leaf over the data axes but ``data`` for the ``fsdp``
experts, whose all-gather's backward already summed them there; the
router over ``model`` as well: each rank's share covers only its experts'
entries).  ``expert_axes`` names the dims the experts' blocks split over.

On DTensors (the dry-run, ``launch/dryrun.py``) ``moe_block`` runs that
rank-local path on each rank's blocks under ``local_map``: the dispatch's
sort, top-k and ``index_add`` have no DTensor rule that keeps the experts
split, and replicating the experts to get one would describe another
program.  The tokens enter split as ``moe_token_spec`` says, the experts
as ``lm_param_specs`` places them, the router and the shared experts
whole; the gradients leave as ``moe_grad_sync`` sums them (partial over
the ranks whose shares differ).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..dist import collectives as coll
from ..dist.context import constrain, group_over, is_dtensor
from ..dist.sharding import DP, P, to_placements
from .common import dense_init

__all__ = ["MoEConfig", "init_moe_params", "moe_block", "dispatch_plan", "moe_token_spec",
           "moe_grad_sync", "expert_axes"]

EXPERTS = ("w1", "w3", "w2")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 512
    n_shared: int = 0
    capacity_factor: float = 1.25
    norm_topk: bool = True  # renormalize the top-k gate weights to sum 1
    fsdp: bool = False  # under a mesh, the expert weights' dim 1 sharded over 'data' too


def init_moe_params(generator: torch.Generator, d_model: int, mcfg: MoEConfig,
                    dtype: torch.dtype = torch.float32) -> dict:
    """Random params on ``generator``'s device, drawn in the order router,
    w1, w3, w2, then (with shared experts) shared_w1, shared_w3, shared_w2;
    each cast to ``dtype`` as soon as it is drawn, the router kept float32."""
    E, F = mcfg.n_experts, mcfg.d_ff_expert
    shapes = [("router", (d_model, E)), ("w1", (E, d_model, F)), ("w3", (E, d_model, F)),
              ("w2", (E, F, d_model))]
    if mcfg.n_shared:
        Fs = mcfg.n_shared * F
        shapes += [("shared_w1", (d_model, Fs)), ("shared_w3", (d_model, Fs)),
                   ("shared_w2", (Fs, d_model))]
    return {name: dense_init(generator, shape).to(torch.float32 if name == "router" else dtype)
            for name, shape in shapes}


def _route(x, router, mcfg: MoEConfig):
    """(T, D) tokens → (top-k expert ids (T, K), their gate weights (T, K)
    float32, the Switch-style load-balance aux loss), gates a float32 softmax."""
    gates = torch.softmax(x.float() @ router.float(), dim=-1)  # (T, E)
    topv, topi = torch.topk(gates, mcfg.top_k, dim=-1)
    if mcfg.norm_topk:
        topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    E = gates.shape[-1]
    me = gates.mean(0)
    ce = torch.nn.functional.one_hot(topi[:, 0], E).float().mean(0)
    return topi, topv, E * torch.sum(me * ce)


def dispatch_plan(topi, topv, mcfg: MoEConfig) -> dict:
    """The (token, expert) entries in expert order with their capacity slots:
    {"cap", "expert", "token", "weight", "rank", "keep"}, each (T·K,) but
    ``cap``; ``keep`` is false for the entries past an expert's capacity."""
    T, K = topi.shape
    cap = max(int(T * K / mcfg.n_experts * mcfg.capacity_factor), 4)
    flat_e = topi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    rank = torch.arange(se.shape[0], device=se.device) - torch.searchsorted(se, se, right=False)
    return {"cap": cap, "expert": se,
            "token": torch.arange(T, device=topi.device).repeat_interleave(K)[order],
            "weight": topv.reshape(-1)[order], "rank": rank, "keep": rank < cap}


def _dispatch_compute(x, router, w1, w3, w2, mcfg: MoEConfig, e_start: int = 0):
    """(T, D) tokens in the compute dtype → (the output (T, D) of the experts
    ``[e_start, e_start + E_loc)`` whose weights ``w1``, ``w3``, ``w2`` are
    (E_loc leading), aux): every token routed over all E experts, the
    capacity of T tokens; the entries routed to these experts dispatched
    into the (E_loc, cap, D) buffer, the expert SwiGLUs as batched products,
    the weighted outputs added back onto their tokens."""
    T, D = x.shape
    dtype, e_local = x.dtype, w1.shape[0]
    topi, topv, aux = _route(x, router, mcfg)
    plan = dispatch_plan(topi, topv, mcfg)
    cap, st, se = plan["cap"], plan["token"], plan["expert"]
    local = plan["keep"] & (se >= e_start) & (se < e_start + e_local)
    # each entry's row of the flat (E_loc·cap, D) buffer; an entry dropped or routed
    # elsewhere reads local expert 0's last slot, weighted 0, as the reference's does
    row = torch.where(local, (se - e_start) * cap + plan["rank"], cap - 1)
    # every local entry writes its own row; the others write a spare row past the
    # buffer, where the reference adds zeros into local expert 0's last slot: the same
    buf = torch.zeros((e_local * cap + 1, D), dtype=dtype, device=x.device)
    buf[torch.where(local, row, e_local * cap)] = x[st].to(dtype)
    buf = buf[:-1].view(e_local, cap, D)
    a = torch.bmm(buf, w1.to(dtype))
    h = a * torch.sigmoid(a) * torch.bmm(buf, w3.to(dtype))
    y = torch.bmm(h, w2.to(dtype)).view(e_local * cap, D)
    back = y[row] * torch.where(local, plan["weight"], 0.0).to(dtype)[:, None]
    out = torch.zeros((T, D), dtype=dtype, device=x.device).index_add(0, st, back)
    return out, aux


def _model_axis(mesh) -> int:
    """The size of ``mesh``'s ``model`` dim (1 without one)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index("model")) if "model" in names else 1


def _data_axes(mesh) -> tuple:
    names = mesh.mesh_dim_names or ()
    return tuple(a for a in DP if a in names and mesh.size(names.index(a)) > 1)


def moe_token_spec(n_tokens: int, mesh) -> P:
    """How ``moe_block``'s tokens split over ``mesh``: over the data axes
    (pod × data) where ``n_tokens`` divides by their size, else replicated
    (a batch-1 decode step), as the reference lays them out."""
    names = mesh.mesh_dim_names or ()
    axes = tuple(a for a in DP if a in names)
    size = math.prod(mesh.size(names.index(a)) for a in axes)
    return P(axes, None) if axes and n_tokens % size == 0 else P(None, None)


def _fsdp(mcfg: MoEConfig, mesh) -> bool:
    names = mesh.mesh_dim_names or ()
    return mcfg.fsdp and "data" in names and mesh.size(names.index("data")) > 1


def expert_axes(mcfg: MoEConfig, mesh) -> tuple:
    """The mesh dims the experts' weights split over under ``mesh``:
    ``model`` where it has more than one rank, ``data`` with ``fsdp``.
    ``moe_block`` runs expert-parallel exactly where this is not empty."""
    if mesh is None:
        return ()
    return (("model",) if _model_axis(mesh) > 1 else ()) + (("data",) if _fsdp(mcfg, mesh) else ())


def _expert_parallel(x2d, params: dict, mcfg: MoEConfig, mesh):
    n = _model_axis(mesh)
    if mcfg.n_experts % n:
        raise ValueError(f"{mcfg.n_experts} experts do not split over {n} model ranks")
    e_local = mcfg.n_experts // n
    # with fsdp each weight's dim 1 (D of w1 and w3, F of w2) splits over 'data'
    n_data = mesh.size(mesh.mesh_dim_names.index("data")) if _fsdp(mcfg, mesh) else 1
    D, F = x2d.shape[1], mcfg.d_ff_expert
    for name, shape in (("w1", (e_local, D // n_data, F)), ("w3", (e_local, D // n_data, F)),
                        ("w2", (e_local, F // n_data, D))):
        if tuple(params[name].shape) != shape:
            raise ValueError(f"this rank's {name} is {tuple(params[name].shape)}, the mesh gives "
                             f"it {shape}: pass its block (dist.sharding.shard_tree)")
    # a model dim of one rank (a data-only mesh with fsdp): no sum over it
    model = mesh.get_group("model") if n > 1 else None
    dtype = x2d.dtype
    w1, w3, w2 = params["w1"], params["w3"], params["w2"]
    if _fsdp(mcfg, mesh):
        # ZeRO-3: dim 1 arrives split over 'data'; gathered just in time, cast
        # first to halve the bytes
        data = mesh.get_group("data")
        w1, w3, w2 = (coll.all_gather(w.to(dtype), data, dim=1) for w in (w1, w3, w2))
    if model is None:
        return _dispatch_compute(x2d, params["router"], w1, w3, w2, mcfg)
    x = coll.copy_to(x2d, model)
    e_start = mesh.get_local_rank("model") * e_local
    out, aux = _dispatch_compute(x, params["router"], w1, w3, w2, mcfg, e_start)
    return coll.sum_over(out, model), coll.sum_over(aux, model) / n


def moe_block(x2d, params: dict, mcfg: MoEConfig, mesh=None):
    """x2d (T, D) → (out (T, D) in x2d's dtype, aux float32): the routed
    experts plus the shared experts (a DTensor (..., D) on each rank's
    tokens, the module doc).  ``mesh=None`` (or a mesh whose dims
    split no expert weight, ``expert_axes``): every expert on this card;
    else expert parallelism over ``mesh`` (the module doc), ``x2d`` and
    ``params`` this rank's blocks."""
    if is_dtensor(x2d):
        return _on_dtensors(x2d, params, mcfg)
    if expert_axes(mcfg, mesh):
        out, aux = _expert_parallel(x2d, params, mcfg, mesh)
    else:
        out, aux = _dispatch_compute(x2d, params["router"], params["w1"], params["w3"],
                                     params["w2"], mcfg)
    if mcfg.n_shared:
        dtype = x2d.dtype
        a = x2d @ params["shared_w1"].to(dtype)
        h = a * torch.sigmoid(a) * (x2d @ params["shared_w3"].to(dtype))
        out = out + h @ params["shared_w2"].to(dtype)
    return out, aux


def _on_dtensors(x, params: dict, mcfg: MoEConfig):
    """``moe_block`` of a DTensor ``x`` (..., D): the rank-local path on each
    rank's blocks (the module doc), its leading dims flattened on the rank →
    (out DTensor (..., D) split as ``x``'s leading dim, aux DTensor, the mean
    over the data shards).  The tokens split by that leading dim
    (``moe_token_spec`` of its size): a flattened DTensor's strided split
    would cost DTensor's redistribution planner minutes a step."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    split = expert_axes(mcfg, mesh)
    data = _data_axes(mesh)
    keys = sorted(params)
    spec = moe_token_spec(x.shape[0], mesh)
    tok = to_placements(mesh, P(spec[0], *([None] * (x.dim() - 1))))

    def place(name):
        if name in EXPERTS:
            return to_placements(mesh, P("model", "data" if "data" in split else None))
        return [Replicate()] * mesh.ndim

    def grad(name):
        # a leaf's gradient is partial over the dims whose ranks' shares differ
        out = []
        for i, (a, p) in enumerate(zip(names, place(name))):
            differ = (a in data and not (name in EXPERTS and a in split)) or (
                name == "router" and a == "model" and "model" in split)
            out.append(Partial() if differ else p)
        return out

    def body(x, *leaves):
        out, aux = moe_block(x.reshape(-1, x.shape[-1]), dict(zip(keys, leaves)), mcfg,
                             mesh if split else None)
        return out.view(x.shape), aux

    aux_place = [Partial("avg") if a in data else Replicate() for a in names]
    fn = local_map(body, out_placements=(tok, aux_place),
                   in_placements=(tok, *[place(k) for k in keys]),
                   in_grad_placements=(tok, *[grad(k) for k in keys]),
                   device_mesh=mesh, redistribute_inputs=True)
    # each leaf placed first by ``constrain``: a gradient partial over 'pod' is then summed on
    # its 'data' blocks before they are gathered, not gathered first
    return fn(x, *[constrain(params[k], place(k)) for k in keys])


def moe_grad_sync(grads: dict, mcfg: MoEConfig, mesh) -> dict:
    """A rank's gradients of its MoE block's params (its blocks, as
    ``moe_block`` took them) → each leaf's gradient over every rank's tokens:
    the leaf summed over the ranks whose shares differ.  Every leaf over the
    data axes (each data shard routed other tokens) but the ``fsdp``
    experts over ``data``, which the all-gather's backward summed there;
    the router over ``model`` too (each rank's share covers its own
    experts' entries).  The shared experts and a replicated router's aux
    share are the same on every ``model`` rank, so they are not summed
    there."""
    if mesh is None or _model_axis(mesh) == 1 and not _data_axes(mesh):
        return grads
    split = expert_axes(mcfg, mesh)
    out = {}
    for name, g in grads.items():
        axes = [a for a in _data_axes(mesh) if name not in EXPERTS or a not in split]
        if name == "router" and _model_axis(mesh) > 1:
            axes.append("model")
        group = group_over(mesh, axes)  # the axes as one group: one all-reduce
        out[name] = g if group is None else coll.all_reduce_sum(g, group)
    return out
