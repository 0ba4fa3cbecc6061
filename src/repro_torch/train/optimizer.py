"""AdamW + cosine schedule + global-norm clipping (counterpart of
``repro/train/optimizer.py``).

A tree here is a dict of tensors, ``{name: tensor}`` (a model's
``dict(named_parameters())``), read in its insertion order. Unlike the
reference's functional update, :func:`adamw_update` writes the new
parameters and moments into the tensors it is given: at the trainer's
sizes (Llama-3-8B cut to 8 layers: 2.8 B float32 parameters, 44.7 GB
with gradients and moments) a second copy of the parameters and moments
would not fit on one card beside the first. Each leaf is computed from
the reference's formula in float32 and then stored, so the numbers are
the reference's.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``: the learning
    rate at ``step`` (an int or an int tensor) as a float32 tensor."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * (s + 1) / max(cfg.warmup_steps, 1)
    t = ((s - cfg.warmup_steps)
         / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(s < cfg.warmup_steps, warm, cfg.lr * cos)


def init_opt_state(params: dict) -> dict:
    """Zero moments in each parameter's dtype, and the step (int32, on the
    parameters' device)."""
    dev = next(iter(params.values())).device
    return {"mu": {n: torch.zeros_like(p) for n, p in params.items()},
            "nu": {n: torch.zeros_like(p) for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over the leaves, in order, of each leaf's sum of
    squares in float32."""
    total = None
    for g in tree.values():
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def step_scalars(cfg: OptConfig, grads: dict, step: torch.Tensor) -> tuple:
    """One step's scalars: (global norm, clip scale ``min(1, clip_norm /
    max(norm, 1e-9))``, learning rate, the bias corrections ``1 - b1^t``,
    ``1 - b2^t``)."""
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    lr = schedule(cfg, step).to(gn.device)
    sf = step.to(torch.float32) + 1
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, device=sf.device), sf)
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, device=sf.device), sf)
    return gn, scale, lr, c1, c2


def update_leaf(cfg: OptConfig, p: torch.Tensor, g: torch.Tensor,
                mu: torch.Tensor, nu: torch.Tensor, scalars: tuple,
                ndim: int | None = None) -> None:
    """AdamW on one leaf (or one block of it), in place on ``p``, ``mu``,
    ``nu``; decay where the whole leaf has ``ndim >= 2`` (default
    ``p``'s)."""
    _, scale, lr, c1, c2 = scalars
    b1, b2 = cfg.b1, cfg.b2
    g = g.float() * scale
    m = b1 * mu.float() + (1 - b1) * g
    v = b2 * nu.float() + (1 - b2) * g * g
    p32 = p.float()
    wd = cfg.weight_decay if (p.dim() if ndim is None else ndim) >= 2 \
        else 0.0
    new = p32 - lr * ((m / c1) / (torch.sqrt(v / c2) + cfg.eps) + wd * p32)
    del g, p32
    mu.copy_(m)
    nu.copy_(v)
    p.copy_(new)


def adamw_update(cfg: OptConfig, params: dict, grads: dict, opt_state: dict,
                 ndims: dict | None = None) -> tuple[dict, dict, dict]:
    """One AdamW step, in place (see the module docstring). The gradients
    are scaled by ``min(1, clip_norm / max(global_norm, 1e-9))``;
    decoupled weight decay applies to leaves with ``ndim >= 2`` only
    (``ndims`` may give a leaf's rank by name: the trainer passes the
    rank in the reference's stacked tree). Returns (params, opt_state,
    {"grad_norm", "lr"})."""
    step = opt_state["step"]
    scalars = step_scalars(cfg, grads, step)
    with torch.no_grad():
        for name, p in params.items():
            update_leaf(cfg, p, grads[name], opt_state["mu"][name],
                        opt_state["nu"][name], scalars,
                        None if ndims is None else ndims[name])
        step += 1
    return params, opt_state, {"grad_norm": scalars[0], "lr": scalars[2]}
