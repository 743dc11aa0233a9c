"""Logical-axis -> mesh-axis sharding rules (torch twin of
``repro.distributed.sharding``), with divisibility-guarded resolution and
optional FSDP parameter sharding, laid out as DTensor placements on a
``DeviceMesh``.

The same rules translate both parameter trees (via their Pm logical axes)
and activations (via ``logical_spec`` / ``shard_act``).  Variants are
alternative ``ShardingRules`` (``make_variant``).

A spec is a tuple with one entry per tensor dim, the entries the
reference's ``PartitionSpec`` holds: None (replicated), a mesh axis name,
or a tuple of axis names the dim is split over jointly, major to minor.
``resolve_spec`` reads only the mesh's axis sizes, so it takes either a
``DeviceMesh`` or a plain ``{axis: size}`` mapping; so do
``sharding_ctx`` and ``ctx_divisible``.

The sharded forward runs the model on DTensors under ``sharding_ctx``:
``shard_act`` lays activations out at the reference's sites,
``replicate`` brings the plain tensors the model makes itself onto the
mesh, ``gather_fsdp`` gathers an FSDP-split layer for its use, and
``local_map`` runs a function (a hand kernel, an in-place cache write) on
each rank's shards.  Outside a mesh context all four leave plain tensors
as they are.

``torch.distributed.tensor`` is imported only where a DTensor is made or
moved: the model code imports this module, and a plain tensor never
needs it.
"""
from __future__ import annotations

import functools
import sys
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.params import tree_map, tree_map_pm


@dataclass(frozen=True)
class ShardingRules:
    """logical axis name -> tuple of mesh axes to shard it over (jointly)."""

    mapping: Dict[str, Tuple[str, ...]]
    # shard each PARAM's largest still-replicated dim over these axes
    # (ZeRO-3/FSDP); applied to parameter trees only, never activations.
    fsdp_axes: Tuple[str, ...] = ()
    name: str = "default"


#: Baseline rules: DP over (pod, data), TP over model for vocab/heads/ffn/
#: experts/recurrent width.  KV-cache seq replicated (variant shards it).
DEFAULT_RULES = ShardingRules(mapping={
    "batch":     ("pod", "data"),
    "vocab":     ("model",),
    "embed":     (),
    "heads":     ("model",),
    "kv_heads":  ("model",),
    "ffn":       ("model",),
    "experts":   ("model",),
    "expert_ff": (),          # variant: shard expert FFN dim instead of E
    "moe_groups": ("model",),  # picks up model when E is not divisible
    "expert_cap": (),
    "seq":       (),
    "seq_saves": (),          # remat-save layout (variant sp_saves -> model)
    "kv_seq":    (),          # decode cache sequence; variant -> ("model",)
    "d_rnn":     ("model",),
    "head_dim":  (),
    "kv_lora":   (),
    "layers":    (),
    "frames":    (),
    "window":    (),
}, name="baseline")


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` (its dims in order), or of a
    plain mapping, as given."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, axes: Tuple[str, ...]) -> int:
    shape = mesh_shape(mesh)
    return int(np.prod([shape[a] for a in axes], dtype=np.int64)) if axes else 1


def resolve_spec(logical: Tuple[Optional[str], ...],
                 shape: Tuple[int, ...],
                 mesh,
                 rules: ShardingRules,
                 fsdp: bool = False) -> tuple:
    """Logical axes -> spec, sharding only divisible dims and never
    reusing a mesh axis within one spec."""
    sizes = mesh_shape(mesh)
    used: set = set()
    parts = []
    for dim, lname in zip(shape, logical):
        cand = rules.mapping.get(lname, ()) if lname else ()
        cand = tuple(a for a in cand if a in sizes and a not in used)
        # longest divisible prefix: ("pod","data","model") degrades to
        # ("pod","data") etc. when the dim doesn't divide the joint size
        placed = None
        while cand:
            size = axis_size(sizes, cand)
            if size > 1 and dim % size == 0:
                placed = cand
                break
            cand = cand[:-1]
        if placed:
            parts.append(placed if len(placed) > 1 else placed[0])
            used.update(placed)
        else:
            parts.append(None)
    if fsdp and rules.fsdp_axes:
        fax = tuple(a for a in rules.fsdp_axes if a in sizes and a not in used)
        fsize = axis_size(sizes, fax)
        if fax and fsize > 1:
            # biggest still-replicated dim that divides
            order = sorted(range(len(shape)), key=lambda i: -shape[i])
            for i in order:
                if parts[i] is None and logical[i] != "layers" and shape[i] % fsize == 0:
                    parts[i] = fax if len(fax) > 1 else fax[0]
                    break
    return tuple(parts)


def _axes(entry) -> Tuple[str, ...]:
    """A spec entry's mesh axes, major to minor."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: tuple, mesh) -> tuple:
    """A spec as DTensor placements, one per mesh dim: ``Shard(d)`` on each
    mesh dim that splits tensor dim d, ``Replicate()`` elsewhere.

    DTensor splits a dim sharded over several mesh dims in mesh-dim order,
    JAX in the spec's order; the two agree only when a joint entry lists
    its axes in mesh order.  The rules' joint entries, ("pod", "data"),
    ("pod", "data", "model") and the FSDP ("data", "model"), all do; any
    other order is refused, not silently transposed."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_shape(mesh))
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        order = [names.index(a) for a in _axes(entry)]
        if order != sorted(order):
            raise ValueError(
                f"spec entry {entry!r} lists mesh axes out of the mesh's "
                f"order {tuple(names)}: DTensor would split dim {dim} in "
                f"another order than the spec")
        for i in order:
            out[i] = Shard(dim)
    return tuple(out)


def window(places, shape: Tuple[int, ...], mesh_dims: Tuple[int, ...],
           coord) -> list:
    """The ``[start, stop]`` per tensor dim that the rank at mesh
    coordinate ``coord`` holds under ``places`` (one per mesh dim,
    sizes ``mesh_dims``): a dim split over several mesh dims is split
    major to minor in mesh-dim order.  Every split must be even, as
    ``resolve_spec`` guarantees."""
    out = []
    for d, n in enumerate(shape):
        idx, parts = 0, 1
        for i, p in enumerate(places):
            if p.is_shard(d):
                idx = idx * mesh_dims[i] + coord[i]
                parts *= mesh_dims[i]
        if n % parts:
            raise ValueError(f"dim {d} of size {n} does not split evenly "
                             f"over {parts} ranks")
        step = n // parts
        out.append([idx * step, (idx + 1) * step])
    return out


def is_dtensor(x) -> bool:
    """True for a DTensor.  No DTensor exists before
    ``torch.distributed.tensor`` is imported, so this imports nothing."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def is_fake(x) -> bool:
    """True for a fake tensor (``FakeTensorMode``: the dry-run's), or a
    DTensor whose shard is one."""
    from torch._subclasses.fake_tensor import is_fake as fake
    return fake(local(x))


def local(t):
    """A DTensor's own shard (a view: writing it writes the DTensor); a
    plain tensor as it is."""
    return t.to_local() if is_dtensor(t) else t


@dataclass(frozen=True)
class Layout:
    """Where one leaf lives: its mesh, the DTensor placements, and the spec
    they came from (the reference's ``NamedSharding(mesh, spec)``)."""

    mesh: Any
    placements: tuple
    spec: tuple


def lay_out(t, layout: Layout):
    """This rank's window of the whole tensor `t`, on the mesh's device, as
    a DTensor of `t`'s global shape (no collective: every rank holds `t`)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import mesh_device
    mesh = layout.mesh
    win = window(layout.placements, tuple(t.shape), tuple(mesh.shape),
                 mesh.get_coordinate())
    local = t[tuple(slice(a, b) for a, b in win)].contiguous()
    return DTensor.from_local(local.to(mesh_device(mesh)), mesh,
                              layout.placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def lay_out_zeros(shape, dtype, layout: Layout):
    """A DTensor of zeros of global ``shape`` laid out as ``layout``: each
    rank allocates its window only."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import mesh_device
    mesh = layout.mesh
    win = window(layout.placements, tuple(shape), tuple(mesh.shape),
                 mesh.get_coordinate())
    local = torch.zeros([b - a for a, b in win], dtype=dtype,
                        device=mesh_device(mesh))
    return DTensor.from_local(local, mesh, layout.placements,
                              run_check=False)


def replicated(mesh) -> Layout:
    """The layout of a leaf whole on every rank (the reference's
    ``NamedSharding(mesh, P())``)."""
    from torch.distributed.tensor import Replicate
    return Layout(mesh, (Replicate(),) * len(mesh_shape(mesh)), ())


def copy_into(buf, src) -> None:
    """``buf.copy_(src)`` that keeps ``buf``'s layout: a DTensor ``buf``
    takes a DTensor of its placements shard for shard, or a whole plain
    tensor (every rank holds all of it) window for window."""
    if not is_dtensor(buf) or is_dtensor(src):
        buf.copy_(src)
        return
    mesh = buf.device_mesh
    win = window(buf.placements, tuple(buf.shape), tuple(mesh.shape),
                 mesh.get_coordinate())
    buf.to_local().copy_(src[tuple(slice(a, b) for a, b in win)])


def like_layout(g, like):
    """``g`` (a gradient) in the placements of ``like`` (its param): a
    partial sum over the batch axes is all-reduced where the param is
    replicated and reduce-scattered where it is split (FSDP), so each rank
    ends with the gradient of its own window.  Plain tensors pass as they
    are."""
    if not is_dtensor(g) or tuple(g.placements) == tuple(like.placements):
        return g
    return g.redistribute(like.device_mesh, like.placements)


def layout_for(logical, shape, mesh, rules: ShardingRules,
               fsdp: bool) -> Layout:
    """The ``Layout`` of one tensor by its logical axes: a parameter's or
    a cache leaf's (``fsdp=True``, as ``param_shardings``), or an
    activation's (``fsdp=False``, as ``shard_act``)."""
    spec = resolve_spec(tuple(logical), tuple(shape), mesh, rules, fsdp=fsdp)
    return Layout(mesh, placements(spec, mesh), spec)


def param_shardings(defs, mesh, rules: ShardingRules):
    """``Layout`` tree for a Pm tree (params or cache/state)."""
    return tree_map_pm(
        lambda p: layout_for(p.logical, p.shape, mesh, rules, fsdp=True), defs)


def logical_spec(logical: Tuple[Optional[str], ...], shape, mesh, rules) -> tuple:
    return resolve_spec(tuple(logical), tuple(shape), mesh, rules, fsdp=False)


# ---------------------------------------------------------------------------
# Activation-sharding context: model code calls shard_act(x, logical_axes)
# and the code that builds the step installs (mesh, rules) once.
# ---------------------------------------------------------------------------

class _Ctx(threading.local):
    mesh: Any = None
    rules: Optional[ShardingRules] = None


_CTX = _Ctx()


@contextmanager
def sharding_ctx(mesh, rules: ShardingRules):
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def in_this_ctx(fn):
    """``fn``, run under the sharding context current now wherever it is
    called: a remat recompute runs in the backward, which on CUDA is
    autograd's device thread, and the context is this thread's."""
    mesh, rules = _CTX.mesh, _CTX.rules

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with sharding_ctx(mesh, rules):
            return fn(*args, **kwargs)
    return run


def shard_act(x, logical: Tuple[Optional[str], ...]):
    """Lay a DTensor out by logical axes (the reference's
    ``with_sharding_constraint``); the identity on a plain tensor and
    outside a context."""
    if _CTX.mesh is None or _CTX.rules is None or not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, act_placements(x, logical))


def ctx_mesh():
    """The context's ``DeviceMesh``; None outside a context, and in one
    over bare axis sizes (there nothing is a DTensor)."""
    mesh = _CTX.mesh
    return None if mesh is None or isinstance(mesh, Mapping) else mesh


def replicate(x):
    """A plain tensor made inside the model (positions, masks, rope
    tables, slot indices) as a ``Replicate`` DTensor on the context's
    mesh, with no copy: DTensor refuses to mix a plain tensor into an op.
    A DTensor, and any tensor outside a mesh context, is returned as it
    is."""
    mesh = ctx_mesh()
    if mesh is None or is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def act_placements(x, logical: Tuple[Optional[str], ...]) -> tuple:
    """The placements ``shard_act`` gives the DTensor `x` under the
    context."""
    spec = resolve_spec(tuple(logical), tuple(x.shape), _CTX.mesh, _CTX.rules)
    return placements(spec, x.device_mesh)


def ctx_spec(logical: Tuple[Optional[str], ...], shape) -> tuple:
    """The spec ``shard_act`` would give a tensor of ``shape`` under the
    context (all None outside one)."""
    if _CTX.mesh is None or _CTX.rules is None:
        return (None,) * len(shape)
    return resolve_spec(tuple(logical), tuple(shape), _CTX.mesh, _CTX.rules)


#: site -> calls in which ``strided_split`` sent that site's products on
#: fake tensors to each rank's own shards (the dry-run's record reads it)
FAKE_LOCAL: Dict[str, int] = {}

#: mesh shape -> whether the installed DTensor flattens two dims that two
#: mesh dims split (``flattens_split_pairs``)
_FLATTENS: Dict[Tuple[int, ...], bool] = {}


def flattens_split_pairs(mesh) -> bool:
    """Whether DTensor, as installed, flattens a tensor's dims 0 and 1 when
    mesh dims 0 and 1 split them (into a ``_StridedShard``): torch 2.13
    does; torch 2.11 refuses ("Attempted to flatten multiple dimensions,
    with dimension 1 being sharded").  Probed once a process and mesh
    shape by a view of a small DTensor so laid out, which moves no data."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    key = tuple(mesh.shape)
    if key not in _FLATTENS:
        if mesh.ndim < 2:
            _FLATTENS[key] = True
        else:
            x = DTensor.from_local(
                torch.zeros(1, 1, 1, device=mesh.device_type), mesh,
                [Shard(0), Shard(1)] + [Replicate()] * (mesh.ndim - 2),
                run_check=False)
            try:
                x.reshape(-1, 1)
                _FLATTENS[key] = True
            except RuntimeError:
                _FLATTENS[key] = False
    return _FLATTENS[key]


def strided_split(x, logical: Tuple[Optional[str], ...], shape, site: str):
    """The mesh dims of a product's operand laid out as ``logical`` (of
    ``shape``) under the context, (dim 0's, dim 1's), where that layout
    splits both its dims 0 and 1 (batch and heads, or batch and groups)
    and none of the rest, and DTensor cannot plan the products: `x` is
    fake (the dry-run's), or the installed DTensor cannot flatten such a
    pair (``flattens_split_pairs``); otherwise None.  Each call on a fake
    `x` is counted under ``site`` in ``FAKE_LOCAL``.

    There DTensor splits the products' flattened (dim 0 x dim 1) dim as a
    ``_StridedShard``: costing its redistribution calls ``.tolist()`` on a
    tensor it builds, which a fake tensor refuses (data-dependent), and
    torch 2.11 has no such flatten at all.  The caller then runs the
    products on each rank's own shards through ``local_map``: the same
    local products.  Elsewhere DTensor keeps planning them, so the
    numerics stay its plan's (ROADMAP Queue 3: the two plans' backwards
    differ)."""
    mesh = ctx_mesh()
    if mesh is None:
        return None
    spec = ctx_spec(logical, shape)
    if None in spec[:2] or any(a is not None for a in spec[2:]):
        return None
    if is_fake(x):
        FAKE_LOCAL[site] = FAKE_LOCAL.get(site, 0) + 1
        return spec[:2]
    if (is_dtensor(x) and all(_axis_ranks(mesh, a) > 1 for a in spec[:2])
            and not flattens_split_pairs(mesh)):
        return spec[:2]
    return None


def _axis_ranks(mesh, entry) -> int:
    """The ranks of the mesh axis, or axes, a spec entry names."""
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    return int(np.prod([mesh.shape[mesh.mesh_dim_names.index(a)]
                        for a in names], dtype=np.int64))


def fit_split(x, dim: int, lead: int):
    """`x` made ready to have its dim ``dim`` reshaped into (``lead``,
    ...): DTensor can only unflatten a dim whose rank count divides the
    leading output size, so where the mesh dims splitting ``dim`` hold
    more ranks than divide ``lead`` (4 xLSTM heads on a 16-wide model
    axis), ``dim`` is gathered whole on them first.  The split of the
    whole dim is then a split of its heads, or none, as a GSPMD reshape
    would lay it out.  A plain tensor, or a split that fits, is returned
    as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    dim = dim % x.ndim
    split = [i for i, p in enumerate(x.placements) if p.is_shard(dim)]
    ranks = int(np.prod([x.device_mesh.shape[i] for i in split],
                        dtype=np.int64))
    if lead % ranks == 0:
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if i in split else p for i, p in enumerate(x.placements)))


def fit_grad(x, dim: int, lead: int):
    """`x` as it is, whose gradient is made ready for the backward of a
    reshape that merged (``lead``, ...) into its dim ``dim``: that
    backward unflattens the gradient's dim, so its split goes through
    ``fit_split`` first.  Apply it to the merged tensor.  A plain tensor
    is returned as it is."""
    if not is_dtensor(x):
        return x
    return _FitGrad.apply(x, dim, lead)


class _FitGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, lead):
        ctx.dim, ctx.lead = dim, lead
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return fit_split(g, ctx.dim, ctx.lead), None, None


def local_map(fn, args, in_axes, out_like=(), grad_placements=None):
    """``fn(*locals)`` on this rank's shards, with stated placements: each
    tensor argument is first laid out by its logical axes in ``in_axes``
    (``shard_act``'s resolution) or by an entry of placements, and handed
    to ``fn`` as its local tensor (a plain tensor enters as ``Replicate``,
    and ``Replicate`` -> ``Shard`` is a local slice, no collective).
    Under autograd the pair carries gradients back: an output's gradient
    is laid out as that output (``from_local``'s backward), and each
    local argument's gradient returns in the placements it was laid out
    by, then through the layout's own backward to the argument's.  The
    entry ``"local"`` hands over a DTensor's own shard as it is laid out,
    so ``fn`` may write into it in place.  Output ``i`` of ``fn`` becomes
    a DTensor with the
    placements of argument ``out_like[i]`` (or, where that entry is a
    tuple, those placements), its global shape that of its local shape
    times the splits.  A function that only writes in place
    returns nothing, with ``out_like=()``.  ``grad_placements`` maps an
    argument's index to the placements its local gradient comes back in,
    where they are not its layout's: a weight whole on every rank that
    each rank applies to its own tokens has a gradient that is a partial
    sum (``Partial``) over the mesh dims that split the tokens.

    Outside a mesh context ``fn`` gets the arguments as they are.  The
    hand kernels are reached through here: they take plain tensors only
    (``kernels/ops.py`` refuses a DTensor), so each rank runs them on its
    own heads or channels and nothing is gathered around them."""
    mesh = ctx_mesh()
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor
    laid, local = [], []
    grads = grad_placements or {}
    for i, (a, axes) in enumerate(zip(args, in_axes)):
        a = replicate(a)
        if axes != "local":
            logical = isinstance(axes[0], str) or axes[0] is None
            a = a.redistribute(mesh, act_placements(a, axes) if logical
                               else tuple(axes))
        laid.append(a)
        # the gradient of the local tensor comes back in these placements
        local.append(a.to_local(grad_placements=grads.get(i, a.placements)))
    out = fn(*local)
    if not out_like:
        return out
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    wrapped = tuple(DTensor.from_local(
        o, mesh, laid[i].placements if isinstance(i, int) else tuple(i),
        run_check=False) for o, i in zip(outs, out_like))
    return wrapped[0] if single else wrapped


def microbatches(x, a: int):
    """``x`` (B, ...) as ``a`` microbatches, (a, B/a, ...), microbatch i
    at index i: the reference's reshape, laid out as it constrains it
    (``repro/train/step.py:82-90``), (None, "batch", ...): the microbatch
    dim whole on every rank, each microbatch split over the batch axes as
    a whole batch is.  On a mesh ``x`` is a DTensor split over the batch
    (its rows are gathered first: a rank's microbatch rows are not its
    batch rows) or a plain tensor whole on every rank."""
    shape = (a, x.shape[0] // a) + tuple(x.shape[1:])
    mesh = ctx_mesh()
    if mesh is None:
        return x.reshape(shape)
    from torch.distributed.tensor import Replicate
    whole = replicate(x).redistribute(mesh, (Replicate(),) * mesh.ndim)
    return shard_act(whole.reshape(shape),
                     (None, "batch") + (None,) * (x.ndim - 1))


def gather_fsdp(tree):
    """ZeRO-3's gather: the DTensor leaves of the params one layer is about
    to read, with their FSDP split (over the rules' ``fsdp_axes``)
    replicated and their tensor-parallel split kept.  The gathered copy
    lives while the layer runs; the stored leaves stay at their windows.
    Under autograd the gather's backward reduce-scatters each leaf's
    gradient (a partial sum over the batch axes) back to its window.
    The tree as it is outside a mesh context or without FSDP."""
    mesh = ctx_mesh()
    if mesh is None or not _CTX.rules.fsdp_axes:
        return tree
    from torch.distributed.tensor import Replicate
    dims = {i for i, n in enumerate(mesh.mesh_dim_names)
            if n in _CTX.rules.fsdp_axes}

    def one(x):
        if not is_dtensor(x) or not any(x.placements[i].is_shard()
                                        for i in dims):
            return x
        return x.redistribute(x.device_mesh, tuple(
            Replicate() if i in dims else p
            for i, p in enumerate(x.placements)))
    return tree_map(one, tree)


def ctx_divisible(lname: str, dim: int) -> bool:
    """Inside a sharding ctx: would a dim of this size shard under logical
    axis `lname`?  True outside any context (single-device paths).  Model
    code uses this to pick sharding-compatible algorithm layouts (e.g. the
    GQA head-fold vs expand-kv decision in attention.py)."""
    if _CTX.mesh is None or _CTX.rules is None:
        return True
    sizes = mesh_shape(_CTX.mesh)
    cand = tuple(a for a in _CTX.rules.mapping.get(lname, ()) if a in sizes)
    size = axis_size(sizes, cand)
    return size <= 1 or dim % size == 0


# ---------------------------------------------------------------------------
# Named rule variants (hillclimbing & ablation configs)
# ---------------------------------------------------------------------------

def make_variant(name: str) -> ShardingRules:
    """Composable variants: "seqshard+fsdp", "kvseq", "dponly+fsdp", ...
    Each '+'-separated part mutates the baseline rules."""
    base = dict(DEFAULT_RULES.mapping)
    fsdp_axes: Tuple[str, ...] = ()
    parts = [p for p in name.split("+") if p]
    for part in parts:
        if part in ("baseline", "default"):
            continue
        elif part == "fsdp":
            fsdp_axes = fsdp_axes or ("data",)
        elif part == "kvseq":      # flash-decode style seq-sharded KV cache
            base["kv_seq"] = ("model",)
            base["kv_heads"] = ()
        elif part == "seqshard":   # sequence parallelism for activations
            base["seq"] = ("model",)
        elif part == "sp_saves":   # shard ONLY remat saves over model
            base["seq_saves"] = ("model",)
        elif part == "expert_ff":  # shard expert FFN dim instead of E axis
            base["experts"] = ()
            base["expert_ff"] = ("model",)
        elif part == "dponly":     # no tensor parallelism (small models)
            for k in ("vocab", "heads", "kv_heads", "ffn", "experts",
                      "d_rnn", "moe_groups"):
                base[k] = ()
            base["batch"] = ("pod", "data", "model")
            if fsdp_axes:
                fsdp_axes = ("data", "model")
        elif part == "dponly_fsdp":
            for k in ("vocab", "heads", "kv_heads", "ffn", "experts",
                      "d_rnn", "moe_groups"):
                base[k] = ()
            base["batch"] = ("pod", "data", "model")
            fsdp_axes = ("data", "model")
        else:
            raise KeyError(f"unknown sharding variant part {part!r}")
    if "dponly" in parts and fsdp_axes:
        fsdp_axes = ("data", "model")     # order-independent composition
    return ShardingRules(mapping=base, fsdp_axes=fsdp_axes, name=name)
