"""Port of repro/models/moe_lm.py: the MoE language model, GQA attention
and the dual-path expert dispatch in every layer.

``MoELM`` is the dense ``DecoderLM`` with ``MoEBlock``s: prefill, the lanes
``chunk_prefill`` and ``decode_step`` keep ``DecoderLM``'s signatures (the
cache updated in place, ``write_mask`` on ``decode_step``), so the
scheduler drives both models alike; each layer's FFN is
``moe.moe_ffn_layer`` in ``dispatch_mode`` (``"staged"`` by default, as in
the JAX package: every layer of every call drains through K1). The JAX
package threads the adaptive mode's hot-expert mask through each call; here
it is the attribute ``hot_mask`` (``forward_with_stats``, ``forward``,
``loss`` and ``loss_with_stats`` also take it as an argument). MoE serves
from the lanes layout only (as in JAX): the paged steps refuse. Training:
``loss`` = cross-entropy + the routers' aux loss, and ``loss_with_stats``
also returns the expert loads ``[L, E]`` that feed the monitor.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..configs.base import MOE, ModelConfig
from . import layers as L
from . import moe as MOE_L
from .transformer import DecoderLM


class MoELM(DecoderLM):
    """Decoder-only MoE LM with the paper's dual-path expert dispatch."""

    family = MOE
    families = (MOE,)
    block_cls = MOE_L.MoEBlock

    def __init__(self, cfg: ModelConfig, device="cuda",
                 dispatch_mode: str = "staged"):
        if dispatch_mode not in MOE_L.DISPATCH_MODES:
            raise ValueError(f"dispatch_mode {dispatch_mode!r} not in "
                             f"{MOE_L.DISPATCH_MODES}")
        super().__init__(cfg, device)
        self.dispatch_mode = dispatch_mode
        self.hot_mask: Optional[torch.Tensor] = None  # bool[E], adaptive

    def _moe(self, blk, x: torch.Tensor, mode: str,
             hot_mask: Optional[torch.Tensor]):
        """The block's MoE FFN on the residual stream ``x`` (pre-norm):
        ``(y, aux_loss, expert_load [E])``."""
        cfg = self.cfg
        return MOE_L.moe_ffn_layer(cfg, blk.moe,
                                   L.apply_norm(cfg, blk.ln2.tensors(), x),
                                   mode, hot_mask)

    def _ffn(self, blk, x: torch.Tensor) -> torch.Tensor:
        return self._moe(blk, x, self.dispatch_mode, self.hot_mask)[0]

    def _ffn_stats(self, blk, x: torch.Tensor, mode: str = "staged",
                   hot_mask: Optional[torch.Tensor] = None):
        y, aux, load = self._moe(blk, x, mode, hot_mask)
        return x + y, aux, load

    # -- full forward (training) ---------------------------------------------
    def forward_with_stats(self, tokens: torch.Tensor,
                           hot_mask: Optional[torch.Tensor] = None,
                           remat: bool = False, mode: Optional[str] = None,
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
        """tokens [B, S] -> (logits fp32 [B, S, V], aux_loss fp32 scalar,
        expert_load int64 [L, E]), causal over the whole sequence, each
        layer ``DecoderLM._block`` (under ``torch.utils.checkpoint`` with
        ``remat``). ``hot_mask`` / ``mode`` default to the model's.
        Differentiable: under grad the staged drains run through
        ``staged_drain`` (K1, its adjoint ``staged_gather``)."""
        mode = mode or self.dispatch_mode
        hot_mask = self.hot_mask if hot_mask is None else hot_mask
        x, positions = self._embed_positions(tokens)
        x, stats = self._trunk(x, positions, remat, mode=mode,
                               hot_mask=hot_mask)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for a, _ in stats:
            aux = aux + a
        return self._logits(x), aux, torch.stack([ld for _, ld in stats])

    def forward(self, tokens: torch.Tensor, media=None, remat: bool = False,
                hot_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.forward_with_stats(tokens, hot_mask, remat)[0]

    def loss(self, batch, remat: bool = True,
             hot_mask: Optional[torch.Tensor] = None,
             mode: Optional[str] = None) -> torch.Tensor:
        """Cross-entropy plus the routers' aux loss."""
        return self.loss_with_stats(batch, remat, hot_mask, mode)[0]

    def loss_with_stats(self, batch, remat: bool = True,
                        hot_mask: Optional[torch.Tensor] = None,
                        mode: Optional[str] = None):
        """``(loss, expert_load [L, E])``: the loads feed the monitor."""
        logits, aux, loads = self.forward_with_stats(
            batch["tokens"], hot_mask, remat, mode)
        return self._ce(logits, batch) + aux, loads

    # -- the paged layout serves the dense family only -----------------------
    def decode_step_paged(self, *args, **kwargs):
        raise NotImplementedError(
            "not ported yet: MoE on the paged layout (the JAX package "
            "serves MoE from the lanes layout only)")

    decode_chunk_paged = decode_step_paged
