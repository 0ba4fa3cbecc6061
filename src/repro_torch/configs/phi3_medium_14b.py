"""Phi-3-medium-14B — dense GQA decoder, RoPE + SwiGLU (the port's own
copy of ``repro/configs/phi3_medium_14b.py``, as published there).

[arXiv:2404.14219; unverified] 40L d_model=5120 40H (GQA kv=10)
d_ff=17920 vocab=100352.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
    head_dim=128,
    rope_theta=10000.0,
)
