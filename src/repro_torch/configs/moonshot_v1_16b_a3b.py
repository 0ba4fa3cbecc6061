"""Moonlight-16B-A3B (kimi/moonshot) — MoE decoder, 64 experts top-6 (the
port's copy of ``repro/configs/moonshot_v1_16b_a3b.py``, as published
there).

[hf:moonshotai/Moonlight-16B-A3B; hf] 48L d_model=2048 16H (kv=16)
expert d_ff=1408 vocab=163840, 64e top-6 + 2 shared experts.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,            # dense fallback dim (unused: all layers MoE)
    vocab_size=163840,
    head_dim=128,
    moe=True,
    n_experts=64,
    moe_top_k=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    rope_theta=50000.0,
)
