"""Jamba-v0.1-52B — hybrid Mamba+attention (1:7) with MoE 16e top-2 (the
port's copy of ``repro/configs/jamba_v0_1_52b.py``, as published there).

[arXiv:2403.19887; hf] 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536; attention at layer period 8 offset 4; MoE period 2 offset 1.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    head_dim=128,
    block="hybrid",
    attn_every=8,
    attn_offset=4,
    moe=True,
    n_experts=16,
    moe_top_k=2,
    moe_every=2,
    moe_offset=1,
    moe_d_ff=14336,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    subquadratic=True,
)
