"""Port of repro/configs/llama_3_2_vision_90b.py: llama-3.2-vision-90b [vlm],
gated cross-attention image layers. [hf:meta-llama/Llama-3.2-*-Vision
family]

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256. Every 5th layer is
a gated cross-attention layer over vision tokens (100 = 80 self + 20 cross).
The vision frontend is a STUB: a request's media are precomputed patch
embeddings (n_image_tokens x d_model). Served from the lanes layout (direct
writes): its cache holds the self layers' K/V and each cross layer's image
K/V, written at admission.
"""
from .base import SWIGLU, VLM, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family=VLM,
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    activation=SWIGLU,
    cross_attn_every=5,
    n_image_tokens=1601,  # one 560x560 tile -> (560/14)^2 + 1 patches
    rope_theta=500_000.0,
)
