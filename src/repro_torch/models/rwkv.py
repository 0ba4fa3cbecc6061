"""RWKV6 (Finch) block: time-mix with data-dependent decay + channel-mix.

Counterpart of ``repro/models/rwkv.py``: ``init_time_mix``,
``_token_shift``, ``_group_norm``, ``time_mix``, ``init_channel_mix`` and
``channel_mix``. The WKV recurrence runs over the whole sequence from the
carried state and returns the final state, in prefill (T = the prompt)
and decode (T = 1) alike: the function of the reference's
``_wkv_sequential`` (its ``impl="xla"`` path), without its chunking, so
any T >= 1 runs.

``impl`` as in ``models.attention``: ``"kernel"`` calls
``kernels.wkv6.ops.wkv6`` (the hand-written kernel on the card, the plain
version on the CPU); ``"ref"`` names the plain version ``wkv6_ref`` on any
device. Heads are the plan's ``n_heads_padded`` (equal to the real count
on one device); padded heads are masked before the output projection.

On a model mesh (``models/parallel.py``) :func:`time_mix` takes a
shard's head blocks and its first head ``head0`` (the head count comes
from the weights' shapes): the WKV recurrence, the group norm and the
mask run on its heads, and ``w_o``'s rows give its partial sum. The
channel mix splits into :func:`channel_mix_partial` (``w_k``
column-parallel, ``w_v`` row-parallel) and :func:`channel_mix_gate`
(the replicated ``w_r``), between which the model axis adds the partial
sums.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.kernels.wkv6.ref import wkv6_ref
from repro_torch.models.attention import check_impl
from repro_torch.models.common import dense, dense_init, param_group
from repro_torch.sharding.rules import ShardPlan

_LORA_RANK = 64
# leaves the reference uses in float32 whatever the activation dtype; the
# port stores them in float32 too (the other leaves are cast to the
# activation dtype at each use, so they are stored in it)
FLOAT32_LEAVES = frozenset({"w0", "u", "ln_scale", "ln_bias"})
# logical axes of each group's leaves (``sharding.axes.logical_axes``), as
# the reference's ``init_time_mix`` / ``init_channel_mix`` annotate them
AXES = {"tm": {"mu": (None, "embed"), "w_r": ("embed", "heads"),
               "w_k": ("embed", "heads"), "w_v": ("embed", "heads"),
               "w_g": ("embed", "heads"), "w0": ("heads",),
               "w_lora_a": ("embed", None), "w_lora_b": (None, "heads"),
               "u": ("heads", None), "ln_scale": ("heads",),
               "ln_bias": ("heads",), "w_o": ("heads", "embed")},
        "cm": {"mu": (None, "embed"), "w_k": ("embed", "mlp"),
               "w_v": ("mlp", "embed"), "w_r": ("embed", None)}}


def _uniform(gen, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device,
                      dtype=torch.float32)


def init_time_mix(gen: torch.Generator, cfg: ModelConfig, plan: ShardPlan,
                  device, dtype=torch.float32) -> nn.ParameterDict:
    d, hs, hp = cfg.d_model, cfg.rwkv_head_size, plan.n_heads_padded
    da = hp * hs                                  # padded attention dim
    f32 = torch.float32
    p = {"mu": _uniform(gen, (5, d), device).to(dtype),
         "w_r": dense_init(gen, d, da, device, dtype),
         "w_k": dense_init(gen, d, da, device, dtype),
         "w_v": dense_init(gen, d, da, device, dtype),
         "w_g": dense_init(gen, d, da, device, dtype),
         "w0": torch.full((da,), -0.6, dtype=f32, device=device),
         "w_lora_a": dense_init(gen, d, _LORA_RANK, device, dtype),
         "w_lora_b": dense_init(gen, _LORA_RANK, da, device, dtype),
         "u": dense_init(gen, hp, hs, device, f32, scale=0.1),
         "ln_scale": torch.ones((da,), dtype=f32, device=device),
         "ln_bias": torch.zeros((da,), dtype=f32, device=device),
         "w_o": dense_init(gen, da, d, device, dtype)}
    return param_group(**p)


def init_time_mix_state(cfg: ModelConfig, plan: ShardPlan, batch: int,
                        dtype, device) -> tuple:
    """(x_prev [B,1,d] in ``dtype``, S [B,H,hs,hs] float32), zero."""
    hs = cfg.rwkv_head_size
    return (torch.zeros((batch, 1, cfg.d_model), dtype=dtype, device=device),
            torch.zeros((batch, plan.n_heads_padded, hs, hs),
                        dtype=torch.float32, device=device))


def _token_shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """[B,S,d] -> previous-token stream; x_prev [B,1,d] carries across."""
    return torch.cat([x_prev.to(x.dtype), x[:, :-1]], dim=1)


def _group_norm(y, scale, bias, h: int, hs: int, eps: float = 1e-5):
    """Per-head LayerNorm (RWKV 'ln_x'), float32 out. y [B,S,H*hs]."""
    shp = y.shape
    yf = y.float().reshape(*shp[:-1], h, hs)
    mu = yf.mean(-1, keepdim=True)
    var = yf.var(-1, keepdim=True, unbiased=False)
    yf = (yf - mu) * torch.rsqrt(var + eps)
    return yf.reshape(shp) * scale.float() + bias.float()


def time_mix(p, cfg: ModelConfig, plan: ShardPlan, x: torch.Tensor, state,
             impl: str = "kernel", head0: int = 0):
    """RWKV6 time mixing. x [B,S,d]; state = (x_prev [B,1,d],
    s [B,H,hs,hs] float32). Returns (out [B,S,d], (x[:, -1:], s_T)). A
    model shard passes its head blocks (``s`` its heads') and ``head0``:
    out is then its partial sum."""
    check_impl(impl)
    b, s_len, _ = x.shape
    hs = cfg.rwkv_head_size
    hp = p["w_r"].shape[1] // hs
    x_prev, wkv_state = state
    xs = _token_shift(x, x_prev)
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xw, xg = (x + (xs - x) * mu[i] for i in range(5))
    f32 = torch.float32
    r = dense(p["w_r"], xr).reshape(b, s_len, hp, hs)
    k = dense(p["w_k"], xk).reshape(b, s_len, hp, hs)
    v = dense(p["w_v"], xv).reshape(b, s_len, hp, hs)
    g = dense(p["w_g"], xg)
    lora = torch.tanh(dense(p["w_lora_a"], xw))
    w_raw = p["w0"].float() + dense(p["w_lora_b"], lora, dtype=f32)
    w = torch.exp(-torch.exp(w_raw)).reshape(b, s_len, hp, hs)  # in (0,1)
    # on meta tensors both take the kernel's meta route: the plain
    # recurrence would loop once per token
    run = wkv6_ops.wkv6 if impl == "kernel" or x.is_meta else wkv6_ref
    y32, s_new = run(r.to(f32), k.to(f32), v.to(f32), w, p["u"].float(),
                     wkv_state.float())
    y = y32.to(x.dtype).reshape(b, s_len, hp * hs)
    y = _group_norm(y, p["ln_scale"], p["ln_bias"], hp, hs).to(x.dtype)
    y = y * F.silu(g)
    mask = (torch.arange(head0, head0 + hp, device=x.device)
            < cfg.n_rwkv_heads).to(y.dtype)
    y = y * mask.repeat_interleave(hs)[None, None, :]
    return dense(p["w_o"], y), (x[:, -1:], s_new)


def init_channel_mix(gen: torch.Generator, cfg: ModelConfig, device,
                     dtype=torch.float32) -> nn.ParameterDict:
    d, dff = cfg.d_model, cfg.d_ff
    return param_group(mu=_uniform(gen, (2, d), device).to(dtype),
                       w_k=dense_init(gen, d, dff, device, dtype),
                       w_v=dense_init(gen, dff, d, device, dtype),
                       w_r=dense_init(gen, d, d, device, dtype))


def channel_mix(p, cfg: ModelConfig, x: torch.Tensor, state: torch.Tensor):
    """RWKV channel mixing. state = x_prev [B,1,d]. Returns (out,
    x[:, -1:])."""
    out = channel_mix_gate(p, x, state) * channel_mix_partial(p, x, state)
    return out, x[:, -1:]


def _cm_mixed(p, x: torch.Tensor, state: torch.Tensor, i: int):
    """The channel mix's token-shift mix ``i`` (0: key, 1: receptance)."""
    xs = _token_shift(x, state)
    return x + (xs - x) * p["mu"].to(x.dtype)[i]


def channel_mix_partial(p, x: torch.Tensor, state: torch.Tensor
                        ) -> torch.Tensor:
    """``relu(xk w_k)^2 w_v``: on a model shard, its ``mlp`` columns of
    ``w_k`` and rows of ``w_v``, a partial sum."""
    k = torch.square(torch.relu(dense(p["w_k"], _cm_mixed(p, x, state, 0))))
    return dense(p["w_v"], k)


def channel_mix_gate(p, x: torch.Tensor, state: torch.Tensor
                     ) -> torch.Tensor:
    """``sigmoid(xr w_r)``, which multiplies the summed value."""
    return torch.sigmoid(dense(p["w_r"], _cm_mixed(p, x, state, 1)))
