"""Port of repro/optim/adamw.py: AdamW (decoupled weight decay) with
global-norm clipping, and the warmup-cosine learning-rate schedule.

Op for op the JAX package's ``update``, in fp32: the global norm of the
gradients, the clip scale ``min(1, clip / max(norm, 1e-12))``, the moments
``b1 * m + (1 - b1) * g`` and ``b2 * v + (1 - b2) * g^2``, the bias
corrections ``1 - b^step`` in fp32, then ``p - lr * (m_hat / (sqrt(v_hat) +
eps) + wd * p)``. There is no Pallas kernel here to port: the steps are
``torch._foreach_*`` lists over the parameters.

The state is keyed by the model's parameter names (``named_parameters``);
on a mesh each value is a ``ShardedTensor`` (the parameter, its gradient
and both moments placed alike) and the update runs piece by piece.
``update`` is functional up to one last in-place write: the new moments are
fresh tensors in a new ``AdamWState``, and the parameters change in place
only at the end, once everything else is computed, so a step that fails
before that leaves the parameters and the old state as they were.

Known difference (pinned by a test): the JAX package decays a leaf when its
``ndim > 1``, and its leaves are stacked on a layer axis, so a block's norm
scales ``[L, D]`` ARE decayed and only ``ln_f`` (``[D]``) is not. The port
keeps one ``[D]`` norm a layer; it decides by the rank of the JAX layout
(``models.layout.jax_ndim``), as the reference's code does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, NamedTuple, Tuple, Union

import torch

from ..distributed.sharding import ShardedTensor, pieces
from ..models.layout import jax_ndim

Tensors = Mapping[str, torch.Tensor]
# the update runs over chunks of at most this many elements a device
_CHUNK = 1 << 27


class AdamWState(NamedTuple):
    step: int                         # updates taken
    mu: Dict[str, torch.Tensor]       # first moment, fp32, by parameter name
    nu: Dict[str, torch.Tensor]       # second moment


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params: Tensors) -> AdamWState:
        mu = {k: torch.zeros_like(p, dtype=torch.float32)
              for k, p in params.items()}
        nu = {k: torch.zeros_like(p, dtype=torch.float32)
              for k, p in params.items()}
        return AdamWState(0, mu, nu)

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=torch.float32, device=step.device)

    @torch.no_grad()
    def update(self, grads: Tensors, state: AdamWState, params: Tensors,
               ) -> Tuple[AdamWState, Dict[str, torch.Tensor]]:
        """Apply one step to ``params`` (in place, last) from fp32
        ``grads`` -> (the new state, metrics {grad_norm, lr} as fp32 0-d
        tensors). ``grads`` may be scaled in place by the clip. Placed
        parameters (``ShardedTensor``, with their gradients and moments
        placed alike) update piece by piece: the norm sums each part of a
        leaf once (``global_norm``), the rest is elementwise, and weight
        decay goes by the rank of the whole leaf in the JAX layout."""
        names = list(params)
        ps = [params[k] for k in names]
        gs = [grads[k] for k in names]
        gnorm = global_norm(gs)
        dev = gnorm.device
        step = torch.tensor(state.step + 1, dtype=torch.float32, device=dev)
        lr = self._lr(step).to(torch.float32)
        scale = None
        if self.clip_norm > 0:
            scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-12),
                                max=1.0)
        # decoupled weight decay, on the leaves of rank > 1 in the JAX layout
        decay = [bool(self.weight_decay) and jax_ndim(k, p.shape) > 1
                 for k, p in zip(names, ps)]
        # the pieces of every leaf (one per leaf unplaced) by device, in
        # chunks of at most _CHUNK elements: the update is elementwise, and
        # a chunk's temporaries are all that exist at once
        chunks: Dict[torch.device, list] = {}
        filled: Dict[torch.device, int] = {}
        for j, p in enumerate(ps):
            for i, piece in enumerate(pieces(p)):
                d = piece.device
                dev_chunks = chunks.setdefault(d, [[]])
                if dev_chunks[-1] and \
                        filled.get(d, 0) + piece.numel() > _CHUNK:
                    dev_chunks.append([])
                    filled[d] = 0
                dev_chunks[-1].append((j, i))
                filled[d] = filled.get(d, 0) + piece.numel()
        new_mu = [list(pieces(state.mu[k])) for k in names]
        new_nu = [list(pieces(state.nu[k])) for k in names]
        deltas = []
        for d, slots in ((d, c) for d, cs in chunks.items() for c in cs):
            sp = [pieces(ps[j])[i] for j, i in slots]
            sg = [pieces(gs[j])[i].float() for j, i in slots]
            mus, nus, delta = self._moments(
                sg, [pieces(state.mu[names[j]])[i] for j, i in slots],
                [pieces(state.nu[names[j]])[i] for j, i in slots],
                [decay[j] for j, _ in slots], sp,
                None if scale is None else scale.to(d), step.to(d),
                lr.to(d))
            for (j, i), m, v in zip(slots, mus, nus):
                new_mu[j][i], new_nu[j][i] = m, v
            deltas.append((sp, delta))
        for sp, delta in deltas:
            torch._foreach_sub_(sp, delta)        # the commit, last
        new = AdamWState(state.step + 1,
                         {k: _like(state.mu[k], m)
                          for k, m in zip(names, new_mu)},
                         {k: _like(state.nu[k], v)
                          for k, v in zip(names, new_nu)})
        return new, {"grad_norm": gnorm, "lr": lr}

    def _moments(self, gs, mu, nu, decay, ps, scale, step, lr):
        """The new moments and the update ``lr * (m_hat / (sqrt(v_hat) +
        eps) + wd * p)`` of one device's pieces, op for op the JAX
        package's."""
        if scale is not None:
            torch._foreach_mul_(gs, scale)
        b1, b2 = self.b1, self.b2
        dev = step.device
        mus = torch._foreach_add(torch._foreach_mul(mu, b1),
                                 torch._foreach_mul(gs, 1 - b1))
        nus = torch._foreach_add(
            torch._foreach_mul(nu, b2),
            torch._foreach_mul(torch._foreach_mul(gs, gs), 1 - b2))
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=dev),
                            step)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=dev),
                            step)
        mhat = torch._foreach_div(mus, bc1)
        den = torch._foreach_sqrt(torch._foreach_div(nus, bc2))
        torch._foreach_add_(den, self.eps)
        delta = torch._foreach_div(mhat, den)
        del mhat, den
        decayed = [i for i, dk in enumerate(decay) if dk]
        if decayed:
            torch._foreach_add_([delta[i] for i in decayed], torch._foreach_mul(
                [ps[i] for i in decayed], self.weight_decay))
        torch._foreach_mul_(delta, lr)
        return mus, nus, delta


def _like(template, parts):
    """``parts`` as ``template`` holds its pieces: placed alike, or the one
    tensor."""
    if isinstance(template, ShardedTensor):
        return ShardedTensor(parts, template.sharding)
    return parts[0]


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum over ``tensors`` (a list or a name -> tensor mapping)
    of each one's sum of squares, in fp32. A placed tensor counts each part
    once (its ``read_group``: a replicated leaf's copy once), its sum on the
    lead device."""
    if isinstance(tensors, Mapping):
        tensors = list(tensors.values())
    total = None
    for t in tensors:
        if isinstance(t, ShardedTensor):
            lead = t.mesh.lead
            s = None
            for _, piece in t.read_group():
                x = torch.sum(torch.square(piece.float())).to(lead)
                s = x if s is None else s + x
        else:
            s = torch.sum(torch.square(t.float()))
        total = s if total is None else total + s.to(total.device)
    return torch.sqrt(total)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup -> cosine decay to ``floor * peak``."""

    def schedule(step) -> torch.Tensor:
        s = torch.as_tensor(step).to(torch.float32)
        warm = s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                           0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return peak_lr * torch.where(s < warmup_steps, warm, cos)

    return schedule
