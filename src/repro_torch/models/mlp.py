"""Dense MLP blocks (SwiGLU / GELU), counterpart of the dense half of
``repro/models/mlp.py``. The Mixture-of-Experts half is not ported."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import dense, dense_init, param_group

ROADMAP_MOE = "ROADMAP.md queue 1 item 13 (models/mlp.py moe)"


def init_mlp(gen: torch.Generator, d: int, d_ff: int, act: str, device,
             dtype=torch.float32) -> nn.ParameterDict:
    """The reference draws ``w_up``, ``w_down`` then ``w_gate``; so does
    this (from one generator, so the numbers differ from the reference's
    split keys)."""
    p = {"w_up": dense_init(gen, d, d_ff, device, dtype),
         "w_down": dense_init(gen, d_ff, d, device, dtype)}
    if act == "swiglu":
        p["w_gate"] = dense_init(gen, d, d_ff, device, dtype)
    return param_group(**p)


def apply_mlp(p, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        h = F.silu(dense(p["w_gate"], x)) * dense(p["w_up"], x)
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(dense(p["w_up"], x), approximate="tanh")
    return dense(p["w_down"], h)


def moe(*args, **kwargs):
    raise NotImplementedError(f"Mixture-of-Experts is not ported: "
                              f"{ROADMAP_MOE}")
