"""Port of repro/configs/zamba2_2_7b.py: zamba2-2.7b [hybrid], a Mamba2
trunk and one shared attention block. [arXiv:2411.15242;
hf:Zyphra/Zamba2-2.7B]

54L d_model=2560 (mamba2 blocks, ssm_state=64) with one SHARED
attention+MLP block (32H, kv=32, head_dim 80, d_ff=10240) applied every 6th
layer, the zamba2 "shared transformer block" design: its weights are reused
at every application, each application keeps its own KV cache. vocab=32000.
Served from the lanes layout (direct writes).
"""
from .base import HYBRID, SWIGLU, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family=HYBRID,
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    activation=SWIGLU,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_conv=4,
    ssm_chunk=256,
    hybrid_attn_every=6,
    rope_theta=10_000.0,
)
