"""Shared model building blocks: norms, linears, RoPE, embeddings.

Counterpart of ``repro/models/common.py``. A parameter group is an
``nn.ParameterDict`` (:func:`param_group`) named as in the reference's
stripped param tree, so ``p["wq"]`` and ``"bias" in p`` read as they do
there. Matrices keep the reference's ``[d_in, d_out]`` layout. The
initialisers take an explicit ``torch.Generator`` and device; their
numbers differ from ``jax.random``'s, so tests carry the reference's
params across (``interop.params_from_numpy``) instead of re-seeding.

Every use of a weight casts it to the activation dtype first, as the
reference does (``dense`` below), so a matrix stored in the activation
dtype gives the same numbers as one stored in float32 and cast per use.
"""
from __future__ import annotations

import torch
from torch import nn

_NORM = {"scale": ("embed",), "bias": ("embed",)}
# logical axes of each group's leaves (``sharding.axes.logical_axes``), as
# the reference's ``embed_init`` / ``norm_init`` annotate them; ``dec_pos``
# is Whisper's learned decoder positions
AXES = {"embed": {"table": ("vocab", "embed")},
        "head": {"table": ("vocab", "embed")},
        "dec_pos": {"table": (None, "embed")},
        **{g: _NORM for g in ("ln1", "ln2", "ln_x", "final_norm",
                              "ln_post")}}


def param_group(**tensors) -> nn.ParameterDict:
    """An ``nn.ParameterDict`` of frozen parameters (inference only). A
    value that is itself a group (a dict or ``nn.ParameterDict``, as the
    MoE's ``shared`` experts) stays a nested group, read as ``p["shared"]
    ["w_up"]``."""
    p = nn.ParameterDict()
    for k, v in tensors.items():
        if isinstance(v, dict):
            v = param_group(**v)
        p[k] = v if isinstance(v, nn.ParameterDict) else \
            nn.Parameter(v, requires_grad=False)
    return p


def normal(gen: torch.Generator, shape, scale: float, device,
           dtype=torch.float32) -> torch.Tensor:
    """``N(0, scale^2)`` drawn in float32 from ``gen`` on ``device``, then
    stored as ``dtype``."""
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    w.mul_(scale)
    return w if dtype == torch.float32 else w.to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, device,
               dtype=torch.float32, scale: float | None = None
               ) -> torch.Tensor:
    scale = (1.0 / d_in) ** 0.5 if scale is None else scale
    return normal(gen, (d_in, d_out), scale, device, dtype)


def dense(w: torch.Tensor, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """``x [..., d_in] @ w [d_in, d_out]`` in ``dtype`` (default x's)."""
    dtype = x.dtype if dtype is None else dtype
    return torch.matmul(x.to(dtype), w.to(dtype))


def norm_init(d: int, kind: str, device) -> dict:
    """Norm parameters, always float32 (``scale``, plus ``bias`` for a
    layernorm)."""
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def apply_norm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """rmsnorm, or layernorm when the group has a ``bias``; computed in
    float32, returned in x's dtype."""
    xf = x.float()
    if "bias" in params:                       # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * params["scale"].float() + params["bias"].float()
    else:                                      # rmsnorm
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * params["scale"].float()
    return y.to(x.dtype)


def rms_norm_1d(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
                ) -> torch.Tensor:
    """Per-head qk-norm (qwen3): normalizes the trailing head_dim."""
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


# -- RoPE --------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x [..., S, H, dh] (dh even); positions [..., S]. Half-split (not
    interleaved) rotation, angles in float32."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                 # [dh/2]
    ang = positions.to(torch.float32)[..., None] * freqs    # [..., S, dh/2]
    cos = torch.cos(ang)[..., None, :]                      # [..., S, 1, dh/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoid_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal positional table [seq, d] in float32: the
    sines of ``pos * 10000^(-2i/d)`` in the first half, their cosines in
    the second."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    inv = torch.exp(-torch.arange(0, d, 2, dtype=torch.float32,
                                  device=device) / d * torch.log(
        torch.tensor(10000.0)))
    ang = pos * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# -- embeddings --------------------------------------------------------------

def embed_init(gen: torch.Generator, vocab_padded: int, d: int, device,
               dtype=torch.float32) -> dict:
    return {"table": normal(gen, (vocab_padded, d), 0.02, device, dtype)}


def embed_lookup(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Rows of the table at ``tokens`` (any shape), in ``dtype``: the
    gather comes first, so only the looked-up rows are cast."""
    return params["table"][tokens.long()].to(dtype)


def lm_head(params, x: torch.Tensor, vocab_size: int, row0: int = 0
            ) -> torch.Tensor:
    """Project to logits; padded vocab rows masked to ``-1e30``. A model
    shard passes its block of the table and the block's first row
    ``row0``: its logits are columns ``row0 ..`` of the whole."""
    table = params["table"]
    logits = torch.matmul(x, table.to(x.dtype).t())
    vp = table.shape[0]
    if row0 + vp > vocab_size:
        pad = torch.arange(row0, row0 + vp, device=x.device) >= vocab_size
        logits = torch.where(pad, torch.full((), -1e30, device=x.device),
                             logits.float()).to(logits.dtype)
    return logits
