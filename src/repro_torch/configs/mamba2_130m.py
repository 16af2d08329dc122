"""Port of repro/configs/mamba2_130m.py: mamba2-130m [ssm], SSD
(state-space duality), attention-free. [arXiv:2405.21060]

24L d_model=768 vocab=50280, ssm_state=128, expand=2 (d_inner=1536),
head_dim=64 (24 SSD heads), 1 B/C group, conv width 4. Ties embeddings
(mamba2-130m shares the LM head with the input embedding). Served from the
lanes layout (direct writes): its cache is a recurrent state a slot.
"""
from .base import SSM, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family=SSM,
    n_layers=24,
    d_model=768,
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
)
