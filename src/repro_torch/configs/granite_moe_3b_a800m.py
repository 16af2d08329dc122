"""Port of repro/configs/granite_moe_3b_a800m.py: granite-moe-3b-a800m
[moe], 40 experts top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base family]

32L d_model=1536 24H (GQA kv=8, head_dim 64) expert_d_ff=512 vocab=49155,
MoE 40e top-8. The assignment line reads "MoE 40e top-8" while its trailing
note says "32 experts"; the explicit spec is implemented: 40 experts, top-8.
Served from the lanes layout (direct KV writes) with staged expert dispatch.
"""
from .base import MOE, SWIGLU, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family=MOE,
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=0,
    vocab=49155,
    activation=SWIGLU,
    n_experts=40,
    top_k=8,
    expert_d_ff=512,
    rope_theta=10_000.0,
)
