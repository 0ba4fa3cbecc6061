"""RWKV6-3B (Finch) — attention-free RNN with data-dependent decay (the
port's copy of ``repro/configs/rwkv6_3b.py``, as published there).

[arXiv:2404.05892; hf] 32L d_model=2560 d_ff=8960 vocab=65536,
head_size 64 (40 wkv heads). O(1)-state decode.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    attention="none",
    block="rwkv",
    rwkv_head_size=64,
    norm="layernorm",
    subquadratic=True,
)
