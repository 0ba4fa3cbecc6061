"""Granite-MoE-3B-A800M — MoE decoder, 40 experts top-8 (the port's own
copy of ``repro/configs/granite_moe_3b_a800m.py``, as published there).

[hf:ibm-granite family; hf] 32L d_model=1536 24H (GQA kv=8) expert
d_ff=512 vocab=49155, 40e top-8.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    moe=True,
    n_experts=40,
    moe_top_k=8,
    moe_d_ff=512,
    rope_theta=10000.0,
)
