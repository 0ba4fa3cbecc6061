"""MiniCPM3-4B — dense decoder with Multi-head Latent Attention (MLA) (the
port's copy of ``repro/configs/minicpm3_4b.py``, as published there).

[hf:openbmb/MiniCPM3-4B; hf] 62L d_model=2560 40H (kv=40) d_ff=6400
vocab=73448. MLA ranks follow the published config (q_lora 768, kv_lora
256, qk nope/rope 64/32, v_head 64).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    attention="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
    head_dim=96,          # qk head dim (nope+rope)
    rope_theta=10000.0,
)
