"""Port of repro/configs/qwen3_moe_235b_a22b.py: qwen3-moe-235b-a22b [moe],
128 experts top-8. [hf:Qwen/Qwen3 family]

94L d_model=4096 64H (GQA kv=4) expert_d_ff=1536 vocab=151936, MoE 128e
top-8. At full width it needs a mesh (expert parallel), which the MoE port
does not have yet; one card serves its reduced() variant.
"""
from .base import MOE, SWIGLU, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family=MOE,
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=0,
    vocab=151936,
    activation=SWIGLU,
    n_experts=128,
    top_k=8,
    expert_d_ff=1536,
    rope_theta=1_000_000.0,
)
