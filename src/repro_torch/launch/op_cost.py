"""Per-rank cost of one step of the port: the counterpart of the JAX
package's ``launch/hlo_cost.py``, which parses the post-SPMD optimized HLO
of a compiled step.  PyTorch runs eagerly and has no HLO, so this module
counts the ops one rank runs as they are dispatched: a
``TorchDispatchMode`` that lets DTensor turn each global op into its local
ops and collectives first (it declines every op on a DTensor), then sees
those local ops, so every count is one rank's and never the whole mesh's.

  * flops: every op with a formula in ``torch.utils.flop_counter``'s
    registry (``mm``, ``bmm``, ``addmm``, convolutions, …) and the kernels
    of the port, whose custom ops (``torch.ops.repro_torch.*``) register
    the work their bounds count; at the local shapes;
  * bytes: operands plus outputs of each local op that moves data (views,
    allocations without a write and metadata queries move none);
    ``bytes_fused`` the same without ``hlo_cost._ELEMENTWISE``'s standalone
    elementwise ops (by their PyTorch names), the lower bound of a program
    whose elementwise chains fuse: eager PyTorch fuses nothing beyond the
    hand-written kernels;
  * collective bytes by kind (all-gather, all-reduce, reduce-scatter,
    all-to-all, collective-permute, broadcast: each collective's output,
    as ``hlo_cost`` counts it), from DTensor's functional collectives (its
    shard-to-shard all-to-all too) and from the ``torch.distributed`` calls
    of ``dist/collectives.py``, which on any backend but gloo (the dry-run's
    fake group stands for NCCL) run as NCCL runs them: a reduce-scatter is
    a reduce-scatter.  A mesh of the CPU's device type runs what gloo can
    (DTensor turns a shard-to-shard all-to-all into an all-gather there),
    so a count of the cards' program takes a mesh of the card's type (the
    dry-run's, on any host).  A group of one rank moves nothing and is not
    counted; a group that resolves to no process group raises, naming the
    op;
  * memory: the bytes of the step's arguments and the peak of the bytes
    alive during the step, both of this rank's storages (each storage
    counted once, at the span of the first tensor seen on it, and freed
    when its last tensor goes).

Eager loops are unrolled as they run, so there is no ``while_trip_counts``:
a layer loop is counted once per layer because each layer's ops run.  The
ops DTensor runs on global fake shapes to propagate its metadata are not
the rank's and are skipped.  An op on DTensors that DTensor cannot split
raises, naming the op: nothing is gathered whole to get past it.  Validated against ``hlo_cost.analyze_hlo`` on
the same programs in ``tests/test_torch_dryrun.py``.
"""
from __future__ import annotations

import sys
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map_only
from torch.utils.flop_counter import flop_registry

__all__ = ["OpCost", "analyze_step"]

# the PyTorch names of hlo_cost._ELEMENTWISE's ops (an in-place form shares its name)
_ELEMENTWISE = {
    "_to_copy", "to", "mul", "add", "sub", "rsub", "div", "maximum", "minimum", "clamp_min",
    "clamp_max", "expand", "eq", "ne", "lt", "le", "gt", "ge", "where", "neg", "exp", "rsqrt",
    "sqrt", "tanh", "log", "pow", "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "logical_and", "logical_or", "logical_xor", "logical_not", "abs", "sign", "floor", "ceil",
    "clamp", "arange", "expm1", "log1p",
}
# ops that allocate without writing, and queries that move no data
_NO_BYTES = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "wait_tensor",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "is_contiguous", "equal",
    "_local_scalar_dense", "set_", "resize_",
}
_COLLECTIVES = {
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "all_gather_into_tensor_out"): "all-gather",
    ("_c10d_functional", "all_gather_into_tensor_coalesced"): "all-gather",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"): "reduce-scatter",
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "all_reduce_"): "all-reduce",
    ("_c10d_functional", "all_reduce_coalesced"): "all-reduce",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    ("_c10d_functional", "broadcast"): "broadcast",
    ("_c10d_functional", "broadcast_"): "broadcast",
    ("_dtensor", "shard_dim_alltoall"): "all-to-all",
    ("c10d", "allreduce_"): "all-reduce",
    ("c10d", "allreduce_coalesced_"): "all-reduce",
    ("c10d", "allgather_"): "all-gather",
    ("c10d", "_allgather_base_"): "all-gather",
    ("c10d", "allgather_into_tensor_coalesced_"): "all-gather",
    ("c10d", "reduce_scatter_"): "reduce-scatter",
    ("c10d", "_reduce_scatter_base_"): "reduce-scatter",
    ("c10d", "reduce_scatter_tensor_coalesced_"): "reduce-scatter",
    ("c10d", "alltoall_"): "all-to-all",
    ("c10d", "alltoall_base_"): "all-to-all",
    ("c10d", "broadcast_"): "broadcast",
    ("c10d", "send"): "collective-permute",
    ("c10d", "recv_"): "collective-permute",
}
_PROPAGATION = "distributed/tensor/_sharding_prop"


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _extent(t: torch.Tensor) -> int:
    """The bytes of ``t``'s storage that ``t`` spans (a meta storage's own
    size is not kept)."""
    if t.numel() == 0:
        return 0
    last = t.storage_offset() + sum((n - 1) * abs(s) for n, s in zip(t.shape, t.stride()))
    return (last + 1) * t.element_size()


def _in_propagation() -> bool:
    """Whether the op runs inside DTensor's sharding propagation, on global
    fake shapes, to derive an output's metadata (not a rank's op)."""
    f = sys._getframe(2)
    while f is not None:
        if _PROPAGATION in f.f_code.co_filename.replace("\\", "/"):
            return True
        f = f.f_back
    return False


def _group_size(func, args) -> int:
    """The ranks of a collective's group (the functional collectives name
    their group; the c10d ops carry it).  A group that resolves to no
    process group raises, naming ``func``: its bytes cannot be counted."""
    group_type = torch._C._distributed_c10d.ProcessGroup
    for a in tree_flatten(args)[0]:
        if isinstance(a, group_type):
            return a.size()
        if isinstance(a, torch.ScriptObject) and "ProcessGroup" in str(a._type()):
            return group_type.unbox(a).size()  # how the dispatcher passes a c10d op's group
        if isinstance(a, str):
            try:
                from torch.distributed.distributed_c10d import _resolve_process_group

                return _resolve_process_group(a).size()
            except (ImportError, KeyError, RuntimeError, ValueError):
                continue
    raise RuntimeError(f"{func}: its process group cannot be resolved, so the ranks it spans "
                       "and the bytes it moves are unknown")


def _functional(ns: str) -> bool:
    """Whether a collective of namespace ``ns`` returns its output (else it
    writes the buffers it takes first, as every c10d op does)."""
    return ns in ("_c10d_functional", "_dtensor")


def _collective_out(ns: str, args, out) -> list:
    """The output tensors of a collective: what it returns, or the buffers
    it writes."""
    return _tensors(out) if _functional(ns) else _tensors(args[0])


class OpCost(TorchDispatchMode):
    """Counts the ops dispatched while it is active (see the module doc);
    ``stats()`` → the counts, ``hlo_cost.analyze_hlo``'s keys."""

    def __init__(self):
        super().__init__()
        from torch.utils.weak import WeakIdKeyDictionary

        self.flops = 0.0
        self.bytes = 0.0
        self.bytes_fused = 0.0
        self.coll = defaultdict(float)
        self.coll_count = 0
        self.n_ops = 0
        self._dtensor_turn = False
        self._seen = WeakIdKeyDictionary()
        self._refs = []
        self.live = 0
        self.peak = 0

    def track(self, tensors) -> int:
        """Count the storages of ``tensors`` as alive until they are freed →
        the bytes newly counted."""
        import weakref

        added = 0
        for t in tensors:
            if not isinstance(t, torch.Tensor) or t.is_sparse:
                continue
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = _extent(t)
            self._seen[st] = n
            self._refs.append(weakref.ref(st, self._freed(n)))
            added += n
        self.live += added
        self.peak = max(self.peak, self.live)
        return added

    def _freed(self, n: int):
        def cb(_ref):
            self.live -= n

        return cb

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self._dtensor_turn:
                self._dtensor_turn = False
                return NotImplemented  # DTensor first: its local ops come back here
            return self._on_dtensors(func, args, kwargs)
        out = func(*args, **kwargs)
        if _in_propagation():
            return out
        packet = func.overloadpacket
        ns, name = func.namespace, packet.__name__
        self.n_ops += 1
        kind = _COLLECTIVES.get((ns, name))
        if kind is not None:
            if _group_size(func, args) > 1:
                self.coll[kind] += _nbytes(_collective_out(ns, args, out))
                self.coll_count += 1
                # operands and outputs; a c10d op's arguments hold both
                b = _nbytes(_tensors(args)) + (_nbytes(_tensors(out)) if _functional(ns) else 0)
                self.bytes += b
                self.bytes_fused += b
            self.track(_tensors(out))
            return out
        if ns == "prim" or func.is_view or name in _NO_BYTES:
            self.track(_tensors(out))
            return out
        outs = _tensors(out)
        if outs:
            b = _nbytes(_tensors((args, kwargs))) + _nbytes(outs)
            self.bytes += b
            if name.rstrip("_") not in _ELEMENTWISE:
                self.bytes_fused += b
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        self.track(outs)
        return out

    def _redispatch(self, func, args, kwargs):
        with self:
            self._dtensor_turn = True
            try:
                return func(*args, **kwargs)
            finally:
                self._dtensor_turn = False

    def _on_dtensors(self, func, args, kwargs):
        """``func`` on DTensors by DTensor's own rule; where it has none, or
        its rule fails, its error (of the same type) gets a note naming
        ``func``."""
        try:
            return self._redispatch(func, args, kwargs)
        except Exception as e:
            if not _in_propagation():
                e.add_note(f"raised by {func} on DTensors")
            raise

    def stats(self) -> dict:
        return {
            "flops": float(self.flops),
            "bytes": float(self.bytes),
            "bytes_fused": float(self.bytes_fused),
            "collective_bytes": {k: float(v) for k, v in self.coll.items()},
            "collective_bytes_total": float(sum(self.coll.values())),
            "collective_count": int(self.coll_count),
            "n_ops": int(self.n_ops),
        }


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def analyze_step(fn, *args, real: bool = False) -> dict:
    """Run ``fn(*args)`` once under ``OpCost`` → its per-rank counts, with
    ``memory``: {"argument_size_in_bytes", "peak_memory_in_bytes"} (this
    rank's storages of the arguments, and the most alive at once, the
    arguments included).

    By default nothing is allocated or computed: on meta tensors (or
    DTensors of them, the dry-run's; a host scalar may go beside them)
    ``fn`` runs as it is, else under
    ``FakeTensorMode``, the mode of the fake tensors in ``args`` or a new
    one with every plain tensor of ``args`` made fake.  ``real=True`` runs
    ``fn`` on ``args`` as they are (a real step on the card, whose counts
    the dry-run's step of the same program must equal)."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode

    leaves = [_local(t) for t in _tensors(args)]
    cost = OpCost()
    if real or any(t.is_meta for t in leaves):
        ctx = None
    else:
        ctx = detect_fake_mode(leaves)
        if ctx is None:
            ctx = FakeTensorMode()
            args = tree_map_only(torch.Tensor, ctx.from_tensor, args)
            leaves = _tensors(args)
    cost.track(leaves)
    arg_bytes = cost.live
    if ctx is None:
        with cost:
            out = fn(*args)
    else:
        with ctx, cost:
            out = fn(*args)
    del out
    res = cost.stats()
    res["memory"] = {"argument_size_in_bytes": int(arg_bytes),
                     "peak_memory_in_bytes": int(cost.peak)}
    return res
