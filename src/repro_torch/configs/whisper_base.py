"""Whisper-base — audio encoder-decoder backbone, conv front end a stub
(the port's copy of ``repro/configs/whisper_base.py``, as published
there).

[arXiv:2212.04356; unverified] 6L(enc)+6L(dec) d_model=512 8H d_ff=2048
vocab=51865. The encoder takes precomputed frame embeddings
``[B, enc_seq, d_model]`` (``batch["enc_frames"]``): the conv1d front end
is a stub in the reference too.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,            # decoder layers
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    head_dim=64,
    enc_dec=True,
    n_enc_layers=6,
    enc_seq=1500,
    frontend="audio_stub",
    mlp_act="gelu",
    norm="layernorm",
)
