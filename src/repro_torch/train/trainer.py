"""Port of repro/train/trainer.py: the microbatched train step and the
fault-tolerant Trainer.

train_step
----------
* gradient accumulation: the global batch splits into M microbatches run
  one after the other with an fp32 gradient accumulator, divided by M (the
  loss likewise);
* remat: each layer under ``torch.utils.checkpoint`` inside the model
  (``remat=True``): K3's forward runs twice a layer, its backward once;
  zamba's and the VLM's groups are checkpointed around their checkpointed
  layers, as the JAX package nests them (a layer nested so runs three
  times);
* MoE monitor: the expert loads of the step add to
  ``TrainState.expert_counts``, and the NEXT step's adaptive hot mask is
  ``core.decision.expert_hot_mask`` of them, taken between steps (the
  paper's thresholds recalibrated off the critical path).

The JAX step is a pure function (state, batch) -> (state, metrics). Here the
parameters are the model's fp32 masters, changed in place, and that is the
last thing a step does (``AdamW.update``): the gradients, the new moments,
the counters and the mask are made first, so a step that fails before the
commit leaves the state as it was, and a retry starts from it. After the
commit the model's cached compute-type copies are dropped
(``layers.drop_casts``), so serving after training reads the new weights.

On a mesh (``init_train_state(..., parallel=)`` or ``place_train_state``,
then ``make_train_step(..., mesh=)``): every family (``models.parallel``).
The masters and both AdamW moments live as pieces
on their devices (``ShardedTensor``, placed by ``state_shardings``; the
model keeps only ``meta`` tensors of their shapes); each microbatch (rows in
JAX's order) is split over the dp axes by ``batch_pspec`` and its loss and
gradients come from ``models.parallel.sharded_loss``; a leaf the batch axes
do not split has its gradient summed over them; AdamW updates piece by
piece. The MoE counters and the hot mask stay whole on the lead device, as
the decision plane does in serving. The commit is still the last thing a
step does.

Trainer (host loop) fault tolerance
-----------------------------------
* a checkpoint every N steps (async, atomic, one write in flight) and
  resume from the latest (``maybe_resume``, with ``pipeline.skip_to``);
* stragglers: an EWMA of the step's wall time (its first step skipped);
  steps slower than ``straggler_factor`` x the EWMA are counted;
* retry: a failing step is retried from the last good state up to
  ``max_retries`` times.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.decision import expert_hot_mask
from ..distributed.sharding import (Mesh, NamedSharding, ParallelConfig,
                                    ShardedTensor, state_shardings,
                                    tree_paths_and_leaves)
from ..models.layers import drop_casts, set_trainable
from ..models.layout import from_jax_tree, jax_key, jax_tree
from ..optim.adamw import AdamW, AdamWState

log = logging.getLogger("repro_torch.train")


class _TrainTree(NamedTuple):
    """The JAX package's ``TrainState``, as its checkpoints hold it."""
    params: Any
    opt: AdamWState
    step: Any
    expert_counts: Any
    hot_mask: Any


@dataclasses.dataclass
class TrainState:
    """``model`` holds the parameters (its fp32 masters); ``opt`` the AdamW
    state by parameter name; ``step`` the steps taken; ``expert_counts``
    (int64 [E]) and ``hot_mask`` (bool [E]) the MoE monitor's, else None.
    On a mesh, ``shards`` holds the masters as ``ShardedTensor`` pieces by
    parameter name (the model's own are ``meta`` tensors), ``opt``'s
    moments likewise, and ``mesh`` is the mesh."""
    model: nn.Module
    opt: AdamWState
    step: int
    expert_counts: Optional[torch.Tensor] = None
    hot_mask: Optional[torch.Tensor] = None
    shards: Optional[Dict[str, ShardedTensor]] = None
    mesh: Optional[Mesh] = None

    @property
    def params(self) -> Dict[str, Any]:
        if self.shards is not None:
            return dict(self.shards)
        return dict(self.model.named_parameters())

    def jax_tree(self, leaf) -> _TrainTree:
        """The JAX package's structure of this state, each leaf made by
        ``leaf(values, stacked)`` (``models.layout.jax_tree``); the counters
        are int32 there."""
        def one(x):
            return None if x is None else leaf([x], False)
        counts = self.expert_counts
        return _TrainTree(
            params=jax_tree(self.params.items(), leaf),
            opt=AdamWState(one(np.asarray(self.opt.step, np.int32)),
                           jax_tree(self.opt.mu.items(), leaf),
                           jax_tree(self.opt.nu.items(), leaf)),
            step=one(np.asarray(self.step, np.int32)),
            expert_counts=one(None if counts is None
                              else counts.to(torch.int32)),
            hot_mask=one(self.hot_mask))

    def from_jax_tree(self, tree: _TrainTree) -> "TrainState":
        """A state read from the JAX structure (``checkpoint.restore``): the
        parameters loaded into this state's model in place, the rest made
        anew on its device; on a mesh every leaf placed by the rules
        instead (the masters as new pieces)."""
        from ..checkpoint import params_from_numpy

        dev = self.model.device
        names = [n for n, _ in self.model.named_parameters()]
        shards = None
        if self.shards is not None:
            shardings = {k: v.sharding for k, v in self.shards.items()}

            def moments(t):
                return {k: ShardedTensor.place(torch.tensor(
                    np.asarray(v, np.float32)), shardings[k])
                    for k, v in from_jax_tree(t, names).items()}
            shards = moments(tree.params)
            for v in shards.values():
                for piece in v.shards:
                    piece.requires_grad_(True)
        else:
            params_from_numpy(tree.params, self.model)

            def moments(t):
                return {k: torch.tensor(np.asarray(v, np.float32), device=dev)
                        for k, v in from_jax_tree(t, names).items()}

        def vec(x, dtype):
            return None if x is None else torch.tensor(np.asarray(x),
                                                       dtype=dtype, device=dev)
        return TrainState(self.model,
                          AdamWState(int(tree.opt.step), moments(tree.opt.mu),
                                     moments(tree.opt.nu)),
                          int(tree.step), vec(tree.expert_counts, torch.int64),
                          vec(tree.hot_mask, torch.bool), shards, self.mesh)


def init_train_state(model, optimizer: AdamW, seed: Optional[int] = 0,
                     n_hot_experts: int = 0,
                     parallel: Optional[ParallelConfig] = None) -> TrainState:
    """Training mode on ``model`` (``requires_grad`` on its masters), its
    weights drawn from ``seed`` (None keeps the weights it holds: the tests
    load the JAX package's), the optimizer's zero state, and for MoE zero
    expert counts and, with ``n_hot_experts``, a first hot mask of the
    first ``max(n_hot_experts, 1)`` experts (as the JAX package starts).
    With an enabled ``parallel``, the state is then placed on its mesh
    (``parallel.build_mesh(device=model.device)``) by
    ``place_train_state``."""
    state = _init_state(model, optimizer, seed, n_hot_experts)
    if parallel is not None and parallel.enabled:
        state = place_train_state(state, parallel.build_mesh(
            device=model.device))
    return state


def place_train_state(state: TrainState, mesh: Mesh) -> TrainState:
    """``state`` placed on ``mesh`` by ``state_shardings``: each master and
    both its moments as a ``ShardedTensor`` of its spec (the layer's piece
    of a stacked leaf), the masters' pieces requiring grad; the model's own
    masters become ``meta`` tensors; the counters and the mask stay whole
    on the lead device. Every family: the leaves keyed by their JAX keys
    (``models.layout.jax_key``: a stack's layer takes its piece of the
    stacked leaf's spec; ``shared.*``, ``enc_pos`` and ``dec_pos`` have no
    layer axis)."""
    from ..checkpoint.checkpoint import _spec_leaf
    from ..models.parallel import release_masters

    model = state.model
    if state.shards is not None:
        raise ValueError("the state is placed already")
    tree = state_shardings(model.cfg, mesh, state.jax_tree(_spec_leaf))
    specs = dict(tree_paths_and_leaves(tree))

    def spec(prefix, name):
        key, layer = jax_key(name)
        sp = specs[f"{prefix}/{key}"].spec
        return NamedSharding(mesh, sp if layer is None else sp[1:])

    with torch.no_grad():
        shards = {}
        for k, p in model.named_parameters():
            st = ShardedTensor.place(p.detach(), spec("params", k))
            for piece in st.shards:
                piece.requires_grad_(True)
            shards[k] = st
        mu = {k: ShardedTensor.place(v, spec("opt/mu", k))
              for k, v in state.opt.mu.items()}
        nu = {k: ShardedTensor.place(v, spec("opt/nu", k))
              for k, v in state.opt.nu.items()}
    release_masters(model)
    lead = mesh.lead
    return TrainState(
        model, AdamWState(state.opt.step, mu, nu), state.step,
        None if state.expert_counts is None
        else state.expert_counts.to(lead),
        None if state.hot_mask is None else state.hot_mask.to(lead),
        shards, mesh)


def _init_state(model, optimizer: AdamW, seed: Optional[int],
                n_hot_experts: int) -> TrainState:
    if seed is not None:
        model.init(seed)
    set_trainable(model)
    drop_casts(model)
    cfg = model.cfg
    dev = model.device
    is_moe = getattr(cfg, "n_experts", 0) > 0
    counts = (torch.zeros((cfg.n_experts,), dtype=torch.int64, device=dev)
              if is_moe else None)
    hot = None
    if is_moe and n_hot_experts:
        hot = torch.zeros((cfg.n_experts,), dtype=torch.bool, device=dev)
        hot[:max(n_hot_experts, 1)] = True
    return TrainState(model, optimizer.init(dict(model.named_parameters())),
                      0, counts, hot)


def _split(batch: Dict[str, torch.Tensor], m: int):
    """The M microbatches of ``batch``, rows in order (JAX's reshape): every
    key by its rows, the media of whisper and the VLM too."""
    out = [{} for _ in range(m)]
    for k, a in batch.items():
        b = a.shape[0]
        if b % m:
            raise ValueError(f"batch of {b} rows does not split into {m} "
                             f"microbatches")
        for i, part in enumerate(a.reshape((m, b // m) + tuple(a.shape[1:]))):
            out[i][k] = part
    return out


def make_train_step(model, optimizer: AdamW, *, microbatches: int = 1,
                    remat: bool = True, n_hot_experts: int = 0,
                    mesh: Optional[Mesh] = None,
                    ) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """The (state, batch) -> (state, metrics) step: loss and gradients (over
    ``microbatches`` in turn, accumulated in fp32 and divided by M), one
    AdamW update, and for MoE the counters and the next hot mask. ``batch``:
    ``tokens`` / ``labels`` (and ``loss_mask``; ``media`` for the families
    that read them) on the model's device. With ``mesh`` the sharded step
    (any family, a state placed on that mesh).
    Metrics: ``loss``, ``grad_norm``, ``lr`` (fp32 0-d tensors), ``step``."""
    if mesh is not None:
        return _sharded_train_step(model, optimizer, mesh, microbatches,
                                   remat, n_hot_experts)
    is_moe = getattr(model.cfg, "n_experts", 0) > 0

    def loss_fn(mb, hot):
        if is_moe:
            loss, loads = model.loss_with_stats(mb, remat=remat, hot_mask=hot)
            return loss, loads.sum(dim=0)
        return model.loss(mb, remat=remat), None

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        params = state.params
        plist = list(params.values())
        hot = state.hot_mask
        loss = loads = grads = None
        for mb in ([batch] if microbatches == 1
                   else _split(batch, microbatches)):
            l, e = loss_fn(mb, hot)
            g = torch.autograd.grad(l, plist)
            if grads is None:
                loss, loads = l.detach(), e
                grads = [x.float() for x in g]
            else:
                loss = loss + l.detach()
                loads = None if e is None else loads + e
                torch._foreach_add_(grads, [x.float() for x in g])
            del g
        if microbatches > 1:
            torch._foreach_div_(grads, microbatches)
            loss = loss / microbatches
        counts, new_hot = state.expert_counts, state.hot_mask
        if is_moe and counts is not None:
            counts = counts + loads
            if n_hot_experts:
                # paper §3.2: recalibrate the hot set off the critical path
                new_hot = expert_hot_mask(counts, n_hot_experts)
        new_opt, om = optimizer.update(dict(zip(params, grads)), state.opt,
                                       params)
        drop_casts(state.model)
        metrics = {"loss": loss, **om, "step": state.step + 1}
        return (TrainState(state.model, new_opt, state.step + 1, counts,
                           new_hot), metrics)

    return train_step


def _sharded_train_step(model, optimizer: AdamW, mesh: Mesh,
                        microbatches: int, remat: bool, n_hot_experts: int):
    """``make_train_step`` on ``mesh``: each microbatch's loss and gradients
    from ``models.parallel.sharded_loss`` (every device's copy of the loss
    seeded with 1), accumulated piece by piece in fp32; a leaf's gradient
    then summed over the batch axes that do not split it (the data ranks of
    a replicated leaf; the pods of every leaf); AdamW piece by piece."""
    from ..distributed.collectives import psum
    from ..distributed.sharding import entry_axes
    from ..models import parallel

    plan = parallel.MeshPlan(model, mesh)
    is_moe = plan.n_experts > 0

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        if state.shards is None or state.mesh is not mesh:
            raise ValueError("the state is not placed on this step's mesh "
                             "(init_train_state(..., parallel=) or "
                             "place_train_state)")
        names = list(state.shards)
        params = {k: list(state.shards[k].shards) for k in names}
        flat = [p for k in names for p in params[k]]
        hot = state.hot_mask if state.hot_mask is not None \
            else getattr(model, "hot_mask", None)
        loss = loads = grads = sm = None
        for mb in ([batch] if microbatches == 1
                   else _split(batch, microbatches)):
            losses, e, sm = parallel.sharded_loss(plan, params, mb,
                                                  remat=remat, hot_mask=hot)
            g = torch.autograd.grad(losses, flat)
            l, e = losses[0].detach(), None if e is None else e.sum(dim=0)
            if grads is None:
                loss, loads = l, e
                grads = [x.float() for x in g]
            else:
                loss = loss + l
                loads = None if e is None else loads + e
                torch._foreach_add_(grads, [x.float() for x in g])
            del g, losses
        if microbatches > 1:
            torch._foreach_div_(grads, microbatches)
            loss = loss / microbatches
        placed, at = {}, 0
        with torch.no_grad():
            for k in names:
                st = state.shards[k]
                gk = grads[at:at + len(st.shards)]
                at += len(st.shards)
                split = {a for e_ in st.sharding.spec for a in entry_axes(e_)}
                gk = psum(sm, gk, [a for a in sm.batch_axes
                                   if a not in split], "grad")
                placed[k] = ShardedTensor(gk, st.sharding)
        del grads
        counts, new_hot = state.expert_counts, state.hot_mask
        if is_moe and counts is not None:
            counts = counts + loads
            if n_hot_experts:
                # paper §3.2: recalibrate the hot set off the critical path
                new_hot = expert_hot_mask(counts, n_hot_experts)
        new_opt, om = optimizer.update(placed, state.opt, state.shards)
        metrics = {"loss": loss, **om, "step": state.step + 1}
        return (TrainState(state.model, new_opt, state.step + 1, counts,
                           new_hot, state.shards, mesh), metrics)

    return train_step


# ---------------------------------------------------------------------------
# Host-side Trainer with fault tolerance
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3
    straggler_factor: float = 3.0
    straggler_warmup: int = 5
    max_retries: int = 2
    log_every: int = 10


class Trainer:
    def __init__(self, train_step, state: TrainState, pipeline,
                 cfg: TrainerConfig, put_batch=None):
        self.train_step = train_step
        self.state = state
        self.pipeline = pipeline
        self.cfg = cfg
        dev = state.model.device
        # every key of a batch onto the model's device, media included
        self.put_batch = put_batch or (lambda b: {
            k: torch.as_tensor(v, device=dev) for k, v in b.items()})
        self.ewma_ms: Optional[float] = None
        self.stragglers = 0
        self.retries = 0
        self._ckpt_thread = None
        self.history: list = []
        self.step_ms: list = []    # each step's wall time (to its loss read)

    # -- fault tolerance ----------------------------------------------------
    def maybe_resume(self):
        from .. import checkpoint as ckpt

        if not self.cfg.checkpoint_dir:
            return
        step = ckpt.latest_step(self.cfg.checkpoint_dir)
        if step is None:
            return
        log.info("resuming from checkpoint step %d", step)
        self.state = ckpt.restore(self.cfg.checkpoint_dir, self.state, step)
        self.pipeline.skip_to(int(step))

    def _checkpoint(self, step: int):
        from .. import checkpoint as ckpt

        if not self.cfg.checkpoint_dir:
            return
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()  # never queue more than one write
        self._ckpt_thread = ckpt.save_async(self.cfg.checkpoint_dir, step,
                                            self.state)
        ckpt.prune(self.cfg.checkpoint_dir, self.cfg.keep_checkpoints)

    # -- loop ----------------------------------------------------------------
    def run(self, fault_hook: Optional[Callable[[int], None]] = None) -> Dict:
        """fault_hook(step): test hook that may raise to simulate failures."""
        start = int(self.state.step)
        for step in range(start, self.cfg.total_steps):
            batch = self.put_batch(next(self.pipeline))
            for attempt in range(self.cfg.max_retries + 1):
                try:
                    if fault_hook is not None:
                        fault_hook(step)
                    t0 = time.perf_counter()
                    self.state, metrics = self.train_step(self.state, batch)
                    loss = float(metrics["loss"])   # waits for the device
                    dt_ms = (time.perf_counter() - t0) * 1e3
                    break
                except Exception as e:  # noqa: BLE001 — retry transient faults
                    self.retries += 1
                    log.warning("step %d attempt %d failed: %s", step,
                                attempt, e)
                    if attempt == self.cfg.max_retries:
                        raise
            # straggler detection (EWMA of step time); the first step pays
            # for warm-up and would poison the baseline: skip it
            if step == start:
                pass
            elif self.ewma_ms is None:
                self.ewma_ms = dt_ms
            else:
                if (step - start) > self.cfg.straggler_warmup and dt_ms > (
                        self.cfg.straggler_factor * self.ewma_ms):
                    self.stragglers += 1
                    log.warning("straggler step %d: %.1fms vs EWMA %.1fms",
                                step, dt_ms, self.ewma_ms)
                self.ewma_ms = 0.9 * self.ewma_ms + 0.1 * dt_ms

            self.history.append(loss)
            self.step_ms.append(dt_ms)
            if step % self.cfg.log_every == 0:
                log.info("step %d loss %.4f (%.0f ms)", step, loss, dt_ms)
            if self.cfg.checkpoint_dir and \
                    (step + 1) % self.cfg.checkpoint_every == 0:
                self._checkpoint(step + 1)

        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
        return {
            "final_loss": self.history[-1] if self.history else float("nan"),
            "stragglers": self.stragglers,
            "retries": self.retries,
            "steps": len(self.history),
        }
