"""The collectives of a sharded train step, one process over a mesh.

A sharded value is a list with one tensor per mesh device (list index =
device index, ``Mesh.devices`` order). Each collective runs over the groups
of devices that differ only along its mesh axes, in a fixed order (the
group's order along those axes), so a seed repeats a step bit for bit: a
sum adds the members one after the other on the first member's device and
copies the result to the others.

The step's values have a role on each mesh axis. Over the BATCH axes (the
dp axes its rows are split on, ``StepMesh.batch_axes``) each device holds
its own rows: values VARY. Over every other axis (``model``, and a dp axis
the batch is not split on) every device holds the same value: values are
INVARIANT there, and so is their gradient, the whole of it, as in Megatron.
Every device computes the loss, the same number on all of them, and the
backward starts from 1 on each copy. The backward of each collective is its
transpose under those roles:

* ``all_gather`` (a split tensor made whole): the gradient of each piece is
  its part of the whole's gradient, summed over the members where the whole
  feeds varying values (a reduce-scatter over a batch axis: FSDP), taken
  from its own device's where it is invariant (``model``);
* ``psum`` (partial values summed; the sum is invariant): each input's
  gradient is its own device's output gradient;
* ``copy_to`` (an invariant value about to feed varying work: the residual
  entering a tensor-parallel region): identity forward, its gradient summed
  over the members;
* ``scatter_to`` (each device takes its part of an invariant tensor: the
  padded heads, experts or vocab rows it runs): its gradient gathered;
* ``pmax`` and ``exclusive_prefix`` carry no gradient.

Each call counts its calls and bytes under ``(op, axes, what)``
(``collective_counts``; ``reset_collective_counts``), the counterpart of
the kernels' launch counters: the bytes that arrive at the group's members
from the others, by the ring algorithm (an all-gather or a reduce-scatter
(k - 1) x the whole, an all-reduce 2 (k - 1) x one member's tensor, for a
group of k); a group of one device moves nothing and is not counted. Each
callable in ``OUTPUT_OBSERVERS`` is given every collective's outputs, one
tensor a device, and ``emulating()`` is true while the sums and copies that
stand in for a collective's transfers run (``launch.roofline`` counts a
step device by device from them).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from .sharding import Mesh

_COUNTS: Dict[Tuple[str, Tuple[str, ...], str], List[int]] = {}


# each given every collective's outputs, one tensor a device
OUTPUT_OBSERVERS: List[Callable[[Sequence[torch.Tensor]], None]] = []
# the stand-ins for a collective's transfers running now (nested)
_EMULATING = [0]


def _observed(out):
    for f in OUTPUT_OBSERVERS:
        f(out)
    return out


def _emulated(fn):
    """``fn``'s ops stand in for a collective's transfers: no device's own
    work."""
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        _EMULATING[0] += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _EMULATING[0] -= 1
    return inner


def emulating() -> bool:
    """Whether a collective's stand-in sums and copies are running."""
    return _EMULATING[0] > 0


def _count(op: str, axes, what: str, nbytes: int) -> None:
    c = _COUNTS.setdefault((op, tuple(axes), what), [0, 0])
    c[0] += 1
    c[1] += int(nbytes)


def collective_counts() -> List[Dict]:
    """Every ``(op, axes, what)`` since the last reset with its calls and
    bytes."""
    return [dict(op=op, axes=list(axes), what=what, calls=c, bytes=b)
            for (op, axes, what), (c, b) in sorted(_COUNTS.items())]


def collective_bytes() -> Dict[str, int]:
    """Bytes moved since the last reset by op and axes
    (``"all_gather:data"``)."""
    out: Dict[str, int] = {}
    for (op, axes, _), (_, b) in _COUNTS.items():
        k = f"{op}:{'+'.join(axes)}"
        out[k] = out.get(k, 0) + b
    return out


def reset_collective_counts() -> None:
    _COUNTS.clear()


class StepMesh:
    """A mesh and the dp axes a step's rows are split on."""

    def __init__(self, mesh: Mesh, batch_axes: Sequence[str] = ()):
        self.mesh = mesh
        self.batch_axes = tuple(batch_axes)

    @property
    def n(self) -> int:
        return len(self.mesh.devices)

    def device(self, r: int) -> torch.device:
        return self.mesh.devices[r]

    def size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        out = 1
        for a in axes:
            out *= self.mesh.shape.get(a, 1)
        return out

    def index(self, r: int, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return self.mesh.index(r, [a for a in axes if a in self.mesh.shape])

    def groups(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return self.mesh.groups(axes)


def _axes(sm: StepMesh, axes) -> Tuple[str, ...]:
    """The mesh's axes of ``axes`` that have more than one device."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in axes if sm.mesh.shape.get(a, 1) > 1)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@_emulated
def _sum_group(xs, group, dev):
    """The members' values of ``group`` summed in group order on ``dev``."""
    total = xs[group[0]].to(dev)
    for r in group[1:]:
        total = total + xs[r].to(dev)
    return total


@_emulated
def _allreduce(sm: StepMesh, xs, axes, op: str, what: str):
    """Sum over each group, the result on every member (no autograd)."""
    out = [None] * len(xs)
    for g in sm.groups(axes):
        lead = sm.device(g[0])
        total = _sum_group(xs, g, lead)
        for j, r in enumerate(g):
            # a copy for each member, also on a virtual device: callers
            # update gradients in place
            out[r] = total if j == 0 else total.to(sm.device(r), copy=True)
        if len(g) > 1:
            _count(op, axes, what, 2 * (len(g) - 1) * _nbytes(xs[g[0]]))
    return _observed(out)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sm, axes, what, *xs):
        return tuple(_allreduce(sm, xs, axes, "all_reduce", what))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None) + tuple(gs)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sm, axes, what, *xs):
        ctx.sm, ctx.axes, ctx.what = sm, axes, what
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros((), device=ctx.sm.device(r)) if g is None else g
              for r, g in enumerate(gs)]
        out = _allreduce(ctx.sm, gs, ctx.axes, "all_reduce", ctx.what)
        return (None, None, None) + tuple(out)


@_emulated
def _gather_group(xs, group, dim, dev):
    return torch.cat([xs[r].to(dev) for r in group], dim=dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sm, axis, dim, what, *xs):
        ctx.sm, ctx.axis, ctx.dim, ctx.what = sm, axis, dim, what
        ctx.width = [x.shape[dim] for x in xs]
        out = [None] * len(xs)
        for g in sm.groups(axis):
            whole = None
            for r in g:
                out[r] = _gather_group(xs, g, dim, sm.device(r))
                whole = out[r]
            _count("all_gather", (axis,), what,
                   (len(g) - 1) * _nbytes(whole))
        return tuple(_observed(out))

    @staticmethod
    def backward(ctx, *gs):
        sm, axis, dim = ctx.sm, ctx.axis, ctx.dim
        out = [None] * len(gs)
        reduce = axis in sm.batch_axes
        for g in sm.groups(axis):
            if any(gs[r] is None for r in g):
                # a member whose whole fed nothing: zeros of the whole
                ref = next(gs[r] for r in g if gs[r] is not None)
                gs = list(gs)
                for r in g:
                    if gs[r] is None:
                        gs[r] = torch.zeros_like(ref, device=sm.device(r))
            w = ctx.width[g[0]]
            for j, r in enumerate(g):
                if reduce:
                    part = _sum_group({m: gs[m].narrow(dim, j * w, w)
                                       for m in g}, g, sm.device(r))
                else:
                    part = gs[r].narrow(dim, j * w, w)
                out[r] = part.contiguous()
            if reduce:
                _count("reduce_scatter", (axis,), ctx.what,
                       (len(g) - 1) * _nbytes(gs[g[0]]))
        return (None, None, None, None) + tuple(_observed(out))


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sm, axis, dim, what, *xs):
        ctx.sm, ctx.axis, ctx.dim, ctx.what = sm, axis, dim, what
        out = []
        for r, x in enumerate(xs):
            k = sm.size(axis)
            w = x.shape[dim] // k
            out.append(x.narrow(dim, sm.index(r, axis) * w, w).contiguous())
        return tuple(_observed(out))

    @staticmethod
    def backward(ctx, *gs):
        sm, axis, dim = ctx.sm, ctx.axis, ctx.dim
        out = [None] * len(gs)
        for g in sm.groups(axis):
            ref = next((gs[r] for r in g if gs[r] is not None), None)
            parts = {r: (torch.zeros_like(ref, device=sm.device(r))
                         if gs[r] is None else gs[r]) for r in g}
            for r in g:
                out[r] = _gather_group(parts, g, dim, sm.device(r))
            _count("all_gather", (axis,), ctx.what,
                   (len(g) - 1) * _nbytes(out[g[0]]))
        return (None, None, None, None) + tuple(_observed(out))


def _trivial(sm: StepMesh, axes) -> bool:
    return sm.size(axes) == 1


def psum(sm: StepMesh, xs, axes, what: str):
    """Sum over ``axes``; every member gets the (invariant) sum. Backward:
    each input takes its own device's output gradient."""
    axes = _axes(sm, axes)
    if not axes:
        return list(xs)
    if not torch.is_grad_enabled() or \
            not any(x.requires_grad for x in xs):
        return _allreduce(sm, xs, axes, "all_reduce", what)
    return list(_Psum.apply(sm, axes, what, *xs))


def copy_to(sm: StepMesh, xs, axes, what: str):
    """An invariant value entering varying work over ``axes``: the same
    tensors forward; backward, their gradients summed over ``axes``."""
    axes = _axes(sm, axes)
    if not axes or not torch.is_grad_enabled() or \
            not any(x.requires_grad for x in xs):
        return list(xs)
    return list(_CopyTo.apply(sm, axes, what, *xs))


def all_gather(sm: StepMesh, xs, axis: str, dim: int, what: str):
    """Each group's pieces joined on ``dim`` in group order, the whole on
    every member. Backward: a reduce-scatter over a batch axis, each
    piece's own part elsewhere."""
    if _trivial(sm, axis):
        return list(xs)
    if not torch.is_grad_enabled() or not any(x.requires_grad for x in xs):
        out = [None] * len(xs)
        for g in sm.groups(axis):
            for r in g:
                out[r] = _gather_group(xs, g, dim, sm.device(r))
            _count("all_gather", (axis,), what,
                   (len(g) - 1) * _nbytes(out[g[0]]))
        return _observed(out)
    return list(_AllGather.apply(sm, axis, dim, what, *xs))


def scatter_to(sm: StepMesh, xs, axis: str, dim: int, what: str):
    """Each member's equal part of an invariant tensor on ``dim`` (part
    ``index`` along ``axis``). Backward: the parts' gradients gathered."""
    if _trivial(sm, axis):
        return list(xs)
    return list(_ScatterTo.apply(sm, axis, dim, what, *xs))


@torch.no_grad()
@_emulated
def pmax(sm: StepMesh, xs, axes, what: str):
    """The elementwise max over ``axes`` on every member; no gradient."""
    axes = _axes(sm, axes)
    xs = [x.detach() for x in xs]
    if not axes:
        return xs
    out = [None] * len(xs)
    for g in sm.groups(axes):
        lead = sm.device(g[0])
        m = xs[g[0]]
        for r in g[1:]:
            m = torch.maximum(m, xs[r].to(lead))
        for r in g:
            out[r] = m.to(sm.device(r))
        _count("all_reduce_max", axes, what,
               2 * (len(g) - 1) * _nbytes(xs[g[0]]))
    return _observed(out)


@torch.no_grad()
@_emulated
def exclusive_prefix(sm: StepMesh, xs, axes, what: str):
    """Member ``j`` of each group gets the sum of members ``0..j-1``'s
    values (integers, added in group order); no gradient."""
    axes = _axes(sm, axes)
    out = [None] * len(xs)
    for g in sm.groups(axes):
        run = torch.zeros_like(xs[g[0]])
        for r in g:
            out[r] = run.to(sm.device(r))
            run = run + xs[r].to(run.device)
        if len(g) > 1:
            _count("all_gather", axes, what,
                   len(g) * (len(g) - 1) * _nbytes(xs[g[0]]))
    return _observed(out)


__all__ = [
    "OUTPUT_OBSERVERS", "StepMesh", "all_gather", "collective_bytes",
    "collective_counts", "copy_to", "emulating", "exclusive_prefix", "pmax", "psum",
    "reset_collective_counts", "scatter_to",
]
