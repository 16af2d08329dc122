"""Port of repro/configs/nemotron_4_15b.py."""
from .base import DENSE, SQUARED_RELU, ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family=DENSE,
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab=256000,
    activation=SQUARED_RELU,
    rope_theta=10_000.0,
)
