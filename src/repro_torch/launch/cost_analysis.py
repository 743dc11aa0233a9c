"""Roofline accounting over one rank's traced step (torch twin of
``repro/launch/hlo_analysis.py``).

The reference parses the compiled HLO of the SPMD program, which is one
device's program.  The port has no HLO: ``analyze`` is a dispatch mode
that watches one rank run its step on fake DTensors (the dry-run's
world) and accumulates, PER DEVICE:

  * flops            the rank's LOCAL products: mm/bmm/addmm/baddbmm,
                     convolution and SDPA, by ``torch.utils.flop_counter``'s
                     formulas.  The mode lets DTensor desugar first (it
                     returns ``NotImplemented`` on a DTensor op, as
                     ``CommDebugMode`` does) and counts the ops DTensor
                     then runs on each rank's shards: counted on the
                     DTensor op, a product would be counted at its global
                     shape.  The ops DTensor's sharding propagation runs on
                     global-shape fake tensors to learn an output's
                     metadata are not the rank's work and are skipped.
  * bytes            a model of HBM traffic, not a measurement: the inputs
                     plus outputs of the local ops that the reference's
                     ``_HEAVY`` set would materialise (products,
                     reductions, sort/top-k, cat/stack), the rows touched
                     by gather/index/embedding and by the cache's in-place
                     writes (index_put/scatter: twice the rows written),
                     and each collective's input and output.  Pure
                     elementwise and layout ops are left out, as the
                     reference leaves out the chains XLA fuses.
  * collectives      count and bytes by the reference's kinds, the bytes
                     being the rank's input bytes (the reference counts
                     operands): the functional ``_c10d_functional`` ops
                     DTensor issues and the in-place ``c10d`` ops that a
                     direct ``dist.all_reduce`` makes, merged by kind.  A
                     collective whose group holds ranks of more than one
                     ``NODE_SIZE``-GPU node is inter-node
                     (``coll_internode_bytes``); one whose group holds
                     ranks of more than one pod crosses the data-centre
                     network (``coll_dcn_bytes``, the reference's
                     ``_crosses_pod``).
  * peak temporaries the largest sum of live storages the step created
                     (``peak_temp_bytes``): each new storage counts from
                     the op that made it until its last tensor dies.

A Python loop has no trip count to lose, so the reference's
``unresolved_whiles`` has no counterpart.
"""
from __future__ import annotations

import sys
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: GPUs a node holds (an H100 SXM HGX board); ranks r and s share a node
#: when r // NODE_SIZE == s // NODE_SIZE.
NODE_SIZE = 8

# H100 SXM figures, per GPU.  Arithmetic from published datasheet numbers,
# not measurements of this code.
#: dense bf16 tensor-core peak (NVIDIA H100 datasheet, SXM, without
#: sparsity), the figure chip_smoke.py's bounds use.
PEAK_FLOPS = 989e12
#: HBM3 bandwidth, bytes/s (H100 SXM datasheet), as chip_smoke.py's.
HBM_BW = 3.35e12
#: NVLink 4 inside a node: 900 GB/s bidirectional per GPU (datasheet),
#: 450e9 bytes/s per direction.
NVLINK_BW = 450e9
#: between nodes: one 400 Gb/s InfiniBand NDR port per GPU, 400e9 / 8 =
#: 50e9 bytes/s.
IB_BW = 50e9

# op name (overload packet) -> collective kind, the reference's kinds
# (all-reduce, all-gather, reduce-scatter, all-to-all, collective-permute)
# and broadcast
_KIND = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_":
    "reduce-scatter", "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
_COLL_NS = ("_c10d_functional", "c10d_functional", "c10d",
            "_c10d_functional_autograd")

_PRODUCTS = {"mm", "addmm", "bmm", "baddbmm", "addbmm", "convolution",
             "_convolution", "convolution_backward",
             "_scaled_dot_product_efficient_attention",
             "_scaled_dot_product_flash_attention",
             "_scaled_dot_product_efficient_attention_backward",
             "_scaled_dot_product_flash_attention_backward",
             "_scaled_dot_product_flash_attention_for_cpu",
             "_scaled_dot_product_flash_attention_for_cpu_backward"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod",
               "argmax", "argmin", "cumsum", "cumprod", "logsumexp", "var",
               "var_mean", "std", "norm", "linalg_vector_norm", "_softmax",
               "_log_softmax", "_softmax_backward_data",
               "_log_softmax_backward_data", "sort", "topk", "cat", "stack"}
# billed by the rows they read, not the table they index
_READS = {"gather", "index", "index_select", "embedding", "_unsafe_index"}
# and by the values they write (op -> that argument's position)
_WRITES = {"index_put": 2, "index_put_": 2, "_index_put_impl_": 2,
           "scatter": 3, "scatter_": 3, "scatter_add": 3, "scatter_add_": 3,
           "scatter_reduce": 3, "index_add": 3, "index_add_": 3,
           "index_copy": 3, "index_copy_": 3, "embedding_dense_backward": 0}

# DTensor's sharding propagation runs an op on global-shape fake tensors
# to learn its output's metadata: not the rank's work
_SHADOW = {"_propagate_tensor_meta_non_cached", "_propagate_tensor_meta",
           "gen_fake_args"}


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_dcn_bytes: float = 0.0
    coll_internode_bytes: float = 0.0
    coll_by_kind: Dict[str, float] = field(default_factory=dict)
    coll_count: int = 0


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _in_shadow() -> bool:
    f = sys._getframe(2)
    for _ in range(16):
        if f is None:
            return False
        if f.f_code.co_name in _SHADOW:
            return True
        f = f.f_back
    return False


def _group_ranks(func, args, kwargs) -> tuple:
    """The global ranks of a collective's group: the functional ops name
    it (``group_name``), the in-place ``c10d`` ops carry it."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, str):
            try:
                return tuple(dist.get_process_group_ranks(
                    _resolve_process_group(a)))
            except (ValueError, RuntimeError, KeyError):
                continue
        if isinstance(a, torch.ScriptObject):
            return tuple(dist.get_process_group_ranks(
                dist.ProcessGroup.unbox(a)))
    return tuple(range(dist.get_world_size()))


class analyze(TorchDispatchMode):
    """Records one rank's step: ``with analyze(pod_size=...) as a:
    step(*args)``, then ``a.cost`` (a ``Cost``), ``a.peak_temp_bytes`` and
    ``a.op_table()``.  Enter it inside the ``FakeTensorMode`` the inputs
    were made under, so that it sees each op before the fake mode does.
    ``keep`` holds storages that are not the step's temporaries (its
    arguments)."""

    def __init__(self, pod_size: int = 10 ** 9, keep=()):
        super().__init__()
        self.cost = Cost()
        self.pod_size = pod_size
        self.ops: Dict[object, list] = defaultdict(lambda: [0, 0.0, 0.0])
        self._groups: Dict[tuple, tuple] = {}
        self._live: Dict[int, int] = {}
        self._seen = {id(t.untyped_storage()) for t in keep}
        self._keep = [t.untyped_storage() for t in keep]
        self.live_bytes = self.peak_temp_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented           # let DTensor run its local ops
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.OpOverload) and not _in_shadow():
            self._account(func, args, kwargs, out)
            self._track(out)
        return out

    # -- storages -----------------------------------------------------------

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen or key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_temp_bytes = max(self.peak_temp_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    # -- costs --------------------------------------------------------------

    def _account(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        name = packet.__name__
        ns = func.namespace
        c = self.cost
        flops = nbytes = 0.0
        if ns in _COLL_NS and name in _KIND:
            kind = _KIND[name]
            first = args[0] if args else None
            moved = _nbytes(first)
            c.coll_bytes += moved
            c.coll_by_kind[kind] = c.coll_by_kind.get(kind, 0.0) + moved
            c.coll_count += 1
            internode, dcn = self._span(func, args, kwargs)
            if internode:
                c.coll_internode_bytes += moved
            if dcn:
                c.coll_dcn_bytes += moved
            # in-place ops (a trailing "_") write their input back
            nbytes = moved + (moved if name.endswith("_") else _nbytes(out))
        elif ns == "aten":
            from torch.utils.flop_counter import flop_registry
            if packet in flop_registry:
                flops = float(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
            if name in _PRODUCTS or name in _REDUCTIONS:
                nbytes = _nbytes(args) + _nbytes(out)
            elif name in _READS:
                nbytes = 2 * _nbytes(out)
            elif name in _WRITES:
                i = _WRITES[name]
                vals = args[i] if len(args) > i else None
                nbytes = 2 * (_nbytes(vals) if isinstance(vals, torch.Tensor)
                              else _nbytes(out))
        c.flops += flops
        c.bytes += nbytes
        row = self.ops[func]
        row[0] += 1
        row[1] += flops
        row[2] += nbytes

    def _span(self, func, args, kwargs):
        ranks = _group_ranks(func, args, kwargs)
        if ranks not in self._groups:
            self._groups[ranks] = (
                len({r // NODE_SIZE for r in ranks}) > 1,
                len({r // self.pod_size for r in ranks}) > 1)
        return self._groups[ranks]

    def op_table(self) -> list:
        """[{op, count, flops, bytes}], most flops first."""
        return sorted(({"op": str(k), "count": v[0], "flops": v[1],
                        "bytes": v[2]} for k, v in self.ops.items()),
                      key=lambda r: (-r["flops"], -r["bytes"], r["op"]))


def roofline_terms(cost: Cost, chips: int) -> Dict[str, float]:
    """All terms in seconds, per device (the chips factor cancels, as in
    the reference).  Collective bytes inside a node go over NVLink, the
    inter-node ones (DCN included) over InfiniBand."""
    t_compute = cost.flops / PEAK_FLOPS
    t_memory = cost.bytes / HBM_BW
    intra = cost.coll_bytes - cost.coll_internode_bytes
    t_coll = intra / NVLINK_BW + cost.coll_internode_bytes / IB_BW
    dom = max((t_compute, "compute"), (t_memory, "memory"),
              (t_coll, "collective"))
    return {
        "compute_s": t_compute,
        "memory_s": t_memory,
        "collective_s": t_coll,
        "dominant": dom[1],
        "bound_s": dom[0],
        "roofline_frac_compute": t_compute / max(dom[0], 1e-30),
    }
