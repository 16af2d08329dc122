"""Port of repro/configs/base.py.

Architecture configuration dataclasses (the port's own copy: this package
imports nothing of the JAX package).

``ModelConfig`` is the single source of truth for every assigned architecture
(the 10-arch pool) plus the paper's own experiment config. It deliberately
covers all families — dense / MoE / SSM / hybrid / enc-dec / VLM — with one
flat, explicit schema so that launchers, the dry-run, sharding rules, and the
model constructors all consume the same object.

Design rules
------------
* Configs are frozen dataclasses: hashable, printable, diffable.
* ``reduced()`` derives the CPU-smoke variant of any config (small widths,
  few layers/experts, tiny vocab) while preserving every structural feature
  (GQA ratio, activation, SWA, MoE top-k, SSM state, hybrid period, ...), so
  smoke tests exercise the same code paths as the full config.
* No behavior lives here — just data. Models live in ``repro_torch.models``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

# ---------------------------------------------------------------------------
# Families
# ---------------------------------------------------------------------------
DENSE = "dense"
MOE = "moe"
SSM = "ssm"
HYBRID = "hybrid"
ENCDEC = "encdec"   # whisper: encoder-decoder with (stubbed) audio frontend
VLM = "vlm"         # llama-3.2-vision: decoder + cross-attn image layers

FAMILIES = (DENSE, MOE, SSM, HYBRID, ENCDEC, VLM)

# Activation kinds
SWIGLU = "swiglu"            # llama-style gated MLP (3 matrices)
SQUARED_RELU = "squared_relu"  # nemotron-4 (2 matrices, relu(x)**2)
GELU = "gelu"                # whisper / classic transformer (2 matrices)

# Norm kinds
RMSNORM = "rmsnorm"
LAYERNORM = "layernorm"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture. Field groups are family-gated; unused fields are 0/None."""

    name: str
    family: str

    # ---- trunk dimensions (all families) ----
    n_layers: int
    d_model: int
    vocab: int

    # ---- attention (dense/moe/hybrid/encdec/vlm; 0 heads => attention-free) ----
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0              # 0 => d_model // n_heads
    qkv_bias: bool = False         # qwen2
    sliding_window: int = 0        # 0 => full attention; h2o-danube SWA
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0     # stablelm-2: partial rotary (0.25)
    learned_pos: bool = False      # whisper: learned absolute positions
    max_position: int = 0          # learned-pos table size (0 = unused)

    # ---- MLP ----
    d_ff: int = 0
    activation: str = SWIGLU
    norm: str = RMSNORM
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # ---- MoE (family == moe) ----
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0           # per-expert hidden (assignment lists it as d_ff)
    router_aux_coef: float = 0.01  # load-balance auxiliary loss
    capacity_factor: float = 1.25  # staged-dispatch per-expert capacity

    # ---- SSM / Mamba2 (family in {ssm, hybrid}) ----
    ssm_state: int = 0             # N: state dimension per head
    ssm_expand: int = 2            # d_inner = expand * d_model
    ssm_head_dim: int = 64         # P: channels per SSD head
    ssm_groups: int = 1            # G: B/C groups (GVA)
    ssm_conv: int = 4              # depthwise causal conv width
    ssm_chunk: int = 256           # SSD chunk length

    # ---- hybrid (zamba2): shared attention block applied every N ssm layers ----
    hybrid_attn_every: int = 0     # 0 => no shared attention block

    # ---- enc-dec (whisper) ----
    n_enc_layers: int = 0
    n_audio_frames: int = 1500     # stubbed conv frontend output length (30 s)

    # ---- VLM (llama-3.2-vision) ----
    cross_attn_every: int = 0      # every Nth layer is a cross-attn layer
    n_image_tokens: int = 0        # stubbed vision-frontend output tokens

    # ---- numerics ----
    dtype: str = "bfloat16"        # activation/compute dtype
    param_dtype: str = "float32"   # master parameter dtype

    # ------------------------------------------------------------------
    # Derived properties
    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def attention_free(self) -> bool:
        return self.family == SSM

    @property
    def subquadratic(self) -> bool:
        """Can this arch run the long_500k decode shape?

        SSM/hybrid: O(1) state. SWA: KV bounded by window. Full attention
        with a 512k KV cache is skipped (documented in DESIGN.md).
        """
        return self.family in (SSM, HYBRID) or self.sliding_window > 0

    @property
    def has_decoder(self) -> bool:
        return True  # every pool arch decodes (whisper is enc-dec, not enc-only)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count N (for MODEL_FLOPS = 6·N·D roofline)."""
        return _param_count(self)

    def active_param_count(self) -> int:
        """N_active: MoE counts only top_k of n_experts expert params."""
        return _param_count(self, active_only=True)

    def reduced(self) -> "ModelConfig":
        """CPU-smoke variant: same structure, tiny sizes."""
        r = dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 4 if self.family == HYBRID else 2),
            d_model=64,
            vocab=256,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=0,
            head_dim=16 if self.n_heads else 0,
            d_ff=128 if self.d_ff else 0,
            n_experts=min(self.n_experts, 8),
            top_k=min(self.top_k, 2),
            expert_d_ff=64 if self.expert_d_ff else 0,
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=16,
            sliding_window=min(self.sliding_window, 32),
            hybrid_attn_every=min(self.hybrid_attn_every, 2),
            n_enc_layers=min(self.n_enc_layers, 2),
            n_audio_frames=32 if self.n_enc_layers else self.n_audio_frames,
            cross_attn_every=min(self.cross_attn_every, 2),
            n_image_tokens=16 if self.n_image_tokens else 0,
            max_position=4096 if self.learned_pos else 0,
            dtype="float32",
            param_dtype="float32",
        )
        if r.n_heads:
            # preserve the GQA grouping ratio where possible
            ratio = max(1, self.n_heads // max(self.n_kv_heads, 1))
            object.__setattr__(r, "n_kv_heads", max(1, r.n_heads // min(ratio, r.n_heads)))
        return r


def _attn_params(cfg: ModelConfig) -> int:
    hd = cfg.resolved_head_dim
    q = cfg.d_model * cfg.n_heads * hd
    kv = 2 * cfg.d_model * cfg.n_kv_heads * hd
    o = cfg.n_heads * hd * cfg.d_model
    bias = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd if cfg.qkv_bias else 0
    return q + kv + o + bias


def _mlp_params(cfg: ModelConfig, d_ff: int) -> int:
    if d_ff == 0:
        return 0
    mats = 3 if cfg.activation == SWIGLU else 2
    return mats * cfg.d_model * d_ff


def _ssm_params(cfg: ModelConfig) -> int:
    """Mamba2 block parameter count."""
    d_in = cfg.d_inner
    nh = cfg.ssm_heads
    g = cfg.ssm_groups
    n = cfg.ssm_state
    # in_proj: d_model -> [z(d_in), x(d_in), B(g*n), C(g*n), dt(nh)]
    in_proj = cfg.d_model * (2 * d_in + 2 * g * n + nh)
    conv = cfg.ssm_conv * (d_in + 2 * g * n)  # depthwise conv over x,B,C
    skip = nh * 2 + nh  # A_log, dt_bias, D
    out_proj = d_in * cfg.d_model
    norm = d_in  # gated RMSNorm
    return in_proj + conv + skip + out_proj + norm


def _layer_params(cfg: ModelConfig, layer_kind: str) -> int:
    """Parameter count for one layer of the given kind."""
    d = cfg.d_model
    if layer_kind == "attn+mlp":
        return _attn_params(cfg) + _mlp_params(cfg, cfg.d_ff) + 2 * d
    if layer_kind == "attn+moe":
        experts = cfg.n_experts * 3 * d * cfg.expert_d_ff  # swiglu experts
        router = d * cfg.n_experts
        return _attn_params(cfg) + experts + router + 2 * d
    if layer_kind == "moe_active":
        experts = cfg.top_k * 3 * d * cfg.expert_d_ff
        router = d * cfg.n_experts
        return _attn_params(cfg) + experts + router + 2 * d
    if layer_kind == "ssm":
        return _ssm_params(cfg) + d
    if layer_kind == "cross+mlp":
        return _attn_params(cfg) + _mlp_params(cfg, cfg.d_ff) + 3 * d
    raise ValueError(layer_kind)


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    d = cfg.d_model
    emb = cfg.vocab * d
    head = 0 if cfg.tie_embeddings else cfg.vocab * d
    total = emb + head + d  # + final norm

    if cfg.family in (DENSE,):
        total += cfg.n_layers * _layer_params(cfg, "attn+mlp")
    elif cfg.family == MOE:
        kind = "moe_active" if active_only else "attn+moe"
        total += cfg.n_layers * _layer_params(cfg, kind)
    elif cfg.family == SSM:
        total += cfg.n_layers * _layer_params(cfg, "ssm")
    elif cfg.family == HYBRID:
        total += cfg.n_layers * _layer_params(cfg, "ssm")
        if cfg.hybrid_attn_every:
            # one SHARED attn+mlp block (weights shared across applications)
            total += _layer_params(cfg, "attn+mlp")
    elif cfg.family == ENCDEC:
        total += cfg.n_enc_layers * _layer_params(cfg, "attn+mlp")
        # decoder layers: self-attn + cross-attn + mlp
        total += cfg.n_layers * (
            2 * _attn_params(cfg) + _mlp_params(cfg, cfg.d_ff) + 3 * d
        )
        if cfg.learned_pos:
            total += cfg.max_position * d + cfg.n_audio_frames * d
    elif cfg.family == VLM:
        n_cross = cfg.n_layers // cfg.cross_attn_every if cfg.cross_attn_every else 0
        n_self = cfg.n_layers - n_cross
        total += n_self * _layer_params(cfg, "attn+mlp")
        total += n_cross * _layer_params(cfg, "cross+mlp")
    else:
        raise ValueError(cfg.family)
    return total


# ---------------------------------------------------------------------------
# Input shapes (assigned per-arch shape set)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell.

    ``step``: which program a dry-run cell builds —
      train  -> train_step(tokens[b,s], labels[b,s])
      prefill-> chunk_prefill of the last chunk against a seq_len KV cache
      decode -> decode_step (one new token against a KV cache of seq_len)
    """

    name: str
    seq_len: int
    global_batch: int
    step: str  # train | prefill | decode


TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")

ALL_SHAPES: Tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runnable?, reason-if-skipped) for an (arch x shape) cell."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, (
            "long_500k needs sub-quadratic attention; "
            f"{cfg.name} is pure full-attention (skip per DESIGN.md)"
        )
    return True, ""
