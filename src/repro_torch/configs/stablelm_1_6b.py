"""Port of repro/configs/stablelm_1_6b.py."""
from .base import DENSE, LAYERNORM, SWIGLU, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family=DENSE,
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab=100352,
    activation=SWIGLU,
    norm=LAYERNORM,
    rope_fraction=0.25,
    rope_theta=10_000.0,
)
