"""LLaVA-NeXT-34B — VLM: LM backbone + anyres vision stub (the port's copy
of ``repro/configs/llava_next_34b.py``, as published there).

[hf:llava-hf family; unverified] 60L d_model=7168 56H (GQA kv=8)
d_ff=20480 vocab=64000. The modality frontend is a STUB per the
assignment: input_specs() provides precomputed patch embeddings that
replace the first ``n_prefix_embeds`` positions of the sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    head_dim=128,
    rope_theta=5000000.0,
    frontend="vision_stub",
    n_prefix_embeds=576,   # one anyres tile of 24x24 patches
)
