"""Port of repro/configs/qwen2_7b.py."""
from .base import DENSE, SWIGLU, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family=DENSE,
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    activation=SWIGLU,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
