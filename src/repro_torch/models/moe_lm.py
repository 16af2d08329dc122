"""Port of repro/models/moe_lm.py: the MoE language model, GQA attention
and the dual-path expert dispatch in every layer.

``MoELM`` is the dense ``DecoderLM`` with ``MoEBlock``s: prefill, the lanes
``chunk_prefill`` and ``decode_step`` keep ``DecoderLM``'s signatures (the
cache updated in place, ``write_mask`` on ``decode_step``), so the
scheduler drives both models alike; each layer's FFN is
``moe.moe_ffn_layer`` in ``dispatch_mode`` (``"staged"`` by default, as in
the JAX package: every layer of every call drains through K1). The JAX
package threads the adaptive mode's hot-expert mask through each call; here
it is the attribute ``hot_mask`` (``forward_with_stats`` also takes it as
an argument). MoE serves from the lanes layout only (as in JAX): the paged
steps refuse. ``loss`` / ``loss_with_stats`` (training) are not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..configs.base import MOE, ModelConfig
from . import layers as L
from . import moe as MOE_L
from .transformer import DecoderLM, compute_dtype


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

    def _ffn(self, blk, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        y, _, _ = MOE_L.moe_ffn_layer(
            cfg, blk.moe, L.apply_norm(cfg, blk.ln2.tensors(), x),
            self.dispatch_mode, self.hot_mask)
        return y

    # -- full forward --------------------------------------------------------
    @torch.no_grad()
    def forward_with_stats(self, tokens: torch.Tensor,
                           hot_mask: Optional[torch.Tensor] = None,
                           mode: Optional[str] = None,
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
        """tokens [B, S] -> (logits fp32 [B, S, V], aux_loss fp32 scalar,
        expert_load int64 [L, E]), causal over the whole sequence.
        ``hot_mask`` / ``mode`` default to the model's."""
        cfg = self.cfg
        mode = mode or self.dispatch_mode
        hot_mask = self.hot_mask if hot_mask is None else hot_mask
        dtype = compute_dtype(cfg)
        b, s = tokens.shape
        x = L.embed_tokens(cfg, self.embed.tensors(), tokens, dtype)
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        loads = []
        for blk in self.blocks:
            x, a, load = MOE_L.moe_block(cfg, blk, x, positions, mode,
                                         hot_mask)
            aux = aux + a
            loads.append(load)
        x = L.apply_norm(cfg, self.ln_f.tensors(), x)
        return (L.lm_logits(cfg, self.embed.tensors(), x), aux,
                torch.stack(loads))

    def forward(self, tokens: torch.Tensor,
                hot_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.forward_with_stats(tokens, hot_mask)[0]

    # -- the paged layout serves the dense family only -----------------------
    def decode_step_paged(self, *args, **kwargs):
        raise NotImplementedError(
            "not ported yet: MoE on the paged layout (the JAX package "
            "serves MoE from the lanes layout only)")

    decode_chunk_paged = decode_step_paged
