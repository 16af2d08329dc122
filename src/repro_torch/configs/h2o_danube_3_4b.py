"""Port of repro/configs/h2o_danube_3_4b.py: h2o-danube-3-4b [dense], a
llama+mistral mix with sliding-window attention. [arXiv:2401.16818]

24L d_model=3840 32H (GQA kv=8, head_dim 120) d_ff=10240 vocab=32000, SWA
window 4096: the KV cache is bounded by the window, so the engine serves it
from the dense lanes layout with ring addressing.
"""
from .base import DENSE, SWIGLU, ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family=DENSE,
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab=32000,
    activation=SWIGLU,
    sliding_window=4096,
    rope_theta=10_000.0,
)
