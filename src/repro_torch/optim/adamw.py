"""Port of repro/optim/adamw.py: AdamW (decoupled weight decay) with
global-norm clipping, and the warmup-cosine learning-rate schedule.

Op for op the JAX package's ``update``, in fp32: the global norm of the
gradients, the clip scale ``min(1, clip / max(norm, 1e-12))``, the moments
``b1 * m + (1 - b1) * g`` and ``b2 * v + (1 - b2) * g^2``, the bias
corrections ``1 - b^step`` in fp32, then ``p - lr * (m_hat / (sqrt(v_hat) +
eps) + wd * p)``. There is no Pallas kernel here to port: the steps are
``torch._foreach_*`` lists over the parameters.

The state is keyed by the model's parameter names (``named_parameters``).
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

from ..models.layout import jax_ndim

Tensors = Mapping[str, torch.Tensor]


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
        tensors). ``grads`` may be scaled in place by the clip."""
        names = list(params)
        ps = [params[k] for k in names]
        gs = [grads[k].float() for k in names]
        dev = ps[0].device
        gnorm = global_norm(gs)
        if self.clip_norm > 0:
            scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-12),
                                max=1.0)
            torch._foreach_mul_(gs, scale)
        step = torch.tensor(state.step + 1, dtype=torch.float32, device=dev)
        b1, b2 = self.b1, self.b2
        mus = torch._foreach_add(torch._foreach_mul([state.mu[k] for k in names], b1),
                                 torch._foreach_mul(gs, 1 - b1))
        nus = torch._foreach_add(
            torch._foreach_mul([state.nu[k] for k in names], b2),
            torch._foreach_mul(torch._foreach_mul(gs, gs), 1 - b2))
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=dev),
                            step)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=dev),
                            step)
        lr = self._lr(step).to(torch.float32)
        mhat = torch._foreach_div(mus, bc1)
        den = torch._foreach_sqrt(torch._foreach_div(nus, bc2))
        torch._foreach_add_(den, self.eps)
        delta = torch._foreach_div(mhat, den)
        del mhat, den
        # decoupled weight decay, on the leaves of rank > 1 in the JAX layout
        decayed = [i for i, k in enumerate(names)
                   if self.weight_decay and jax_ndim(k, ps[i].shape) > 1]
        if decayed:
            torch._foreach_add_([delta[i] for i in decayed], torch._foreach_mul(
                [ps[i] for i in decayed], self.weight_decay))
        torch._foreach_mul_(delta, lr)
        torch._foreach_sub_(ps, delta)        # the commit
        new = AdamWState(state.step + 1, dict(zip(names, mus)),
                         dict(zip(names, nus)))
        return new, {"grad_norm": gnorm, "lr": lr}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum over ``tensors`` (a list or a name -> tensor mapping)
    of each one's sum of squares, in fp32."""
    if isinstance(tensors, Mapping):
        tensors = list(tensors.values())
    total = None
    for t in tensors:
        s = torch.sum(torch.square(t.float()))
        total = s if total is None else total + s
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
