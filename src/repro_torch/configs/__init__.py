"""Architecture registry of the port (counterpart of
``repro/configs/__init__.py``).

``ARCHS`` holds the configs the port can run: the dense GQA decoders
``llama3-8b``, ``qwen3-14b`` (with per-head QK-RMSNorm) and
``phi3-medium-14b``, the GQA + MoE decoder ``granite-moe-3b-a800m``, the
MLA decoder ``minicpm3-4b`` (absorbed latent pages), the MoE decoder with
shared experts ``moonshot-v1-16b-a3b``, the VLM backbone
``llava-next-34b`` (image-patch prefix embeddings), the RNN ``rwkv6-3b``,
the hybrid Mamba + attention + MoE ``jamba-v0.1-52b`` and the audio
encoder-decoder ``whisper-base``: every architecture of the reference's
registry. An unknown name raises ``KeyError``. ``SHAPES`` holds the
reference's four input shapes (``ShapeConfig``), which a mesh plan and
``launch.specs`` read; :func:`cell_runnable` says which (arch x shape)
cells the dry run (``launch.dryrun``) lowers.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    granite_moe_3b_a800m,
    jamba_v0_1_52b,
    llama3_8b,
    llava_next_34b,
    minicpm3_4b,
    moonshot_v1_16b_a3b,
    phi3_medium_14b,
    qwen3_14b,
    rwkv6_3b,
    whisper_base,
)
from repro_torch.configs.base import ModelConfig

ARCHS: dict[str, ModelConfig] = {c.name: c for c in [
    llama3_8b.CONFIG, qwen3_14b.CONFIG, phi3_medium_14b.CONFIG,
    granite_moe_3b_a800m.CONFIG, minicpm3_4b.CONFIG,
    moonshot_v1_16b_a3b.CONFIG, llava_next_34b.CONFIG, rwkv6_3b.CONFIG,
    jamba_v0_1_52b.CONFIG, whisper_base.CONFIG]}


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """An input shape of the reference's cells (the same four for every
    LM arch)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str        # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def get_arch(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")


def cell_runnable(arch: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether the dry run lowers this (arch x shape) cell, and else the
    documented reason (the reference's ``cell_runnable``, reason for
    reason): ``long_500k`` needs sub-quadratic attention, so it runs for
    the SSM and hybrid archs and is skipped for pure full-attention
    ones."""
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, "long_500k skipped: pure full-attention arch " \
                      "(O(S^2) attention; see DESIGN.md §5)"
    return True, ""
