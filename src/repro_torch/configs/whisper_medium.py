"""Port of repro/configs/whisper_medium.py: whisper-medium [audio], an
encoder-decoder whose conv frontend is a stub. [arXiv:2212.04356]

24L (encoder) + 24L (decoder) d_model=1024 16H (kv=16 == MHA) d_ff=4096
vocab=51865. GELU MLPs, LayerNorm, learned absolute positions in the
decoder, a learned table over the 1500 audio frames. The mel-spectrogram
conv frontend is a STUB: a request's media are precomputed frame embeddings
(n_audio_frames x d_model). Served from the lanes layout (direct writes):
its cache holds the decoder's self-attention K/V and the cross-attention K/V
the encoder's output gives at admission.
"""
from .base import ENCDEC, GELU, LAYERNORM, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family=ENCDEC,
    n_layers=24,       # decoder layers
    n_enc_layers=24,   # encoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    activation=GELU,
    norm=LAYERNORM,
    learned_pos=True,
    rope_fraction=0.0,  # whisper uses learned absolute positions, no rotary
    max_position=448,       # whisper decoder context
    n_audio_frames=1500,    # 30 s of audio after conv frontend
)
