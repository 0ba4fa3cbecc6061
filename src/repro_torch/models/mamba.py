"""Mamba (S6) block for the Jamba hybrid architecture.

Counterpart of ``repro/models/mamba.py``: ``init_mamba``, ``_causal_conv``
(depthwise, the conv state carried), ``mamba_block`` and
``init_mamba_state``. The selective scan runs over the whole sequence
from the carried state and returns the final state, in prefill and
decode alike: the function of the reference's ``_ssm_sequential`` (its
``impl="xla"`` path), without its chunking, so any T >= 1 runs.

``impl`` as in ``models.attention``: ``"kernel"`` calls
``kernels.mamba_scan.ops.mamba_scan`` (the hand-written kernel on the
card, the plain version on the CPU); ``"ref"`` names the plain version
``mamba_scan_ref`` on any device.

On a model mesh (``models/parallel.py``) the block runs in two parts on
each shard's ``di/m`` channels, :func:`mamba_in` and :func:`mamba_out`,
between which the model axis adds the partial sums of ``w_x``'s
row-parallel product (after which dt, B and C are replicated).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
from repro_torch.models.attention import check_impl
from repro_torch.models.common import dense, dense_init, normal, param_group
from repro_torch.sharding.rules import ShardPlan

# leaves the reference uses in float32 whatever the activation dtype; the
# port stores them in float32 too (the others are cast at each use)
FLOAT32_LEAVES = frozenset({"dt_bias", "a_log", "d"})
# leaves whose product's output splits into equal parts used apart
# (``launch.specs.block`` gives a shard one view a part): ``w_in``'s
# ``xin`` and ``z`` halves
PARTS = {"mamba": {"w_in": 2}}
# logical axes of the group's leaves (``sharding.axes.logical_axes``), as
# the reference's ``init_mamba`` annotates them
AXES = {"mamba": {"w_in": ("embed", "mlp"), "conv_w": (None, "mlp"),
                  "conv_b": ("mlp",), "w_x": ("mlp", None),
                  "w_dt": (None, "mlp"), "dt_bias": ("mlp",),
                  "a_log": ("mlp", None), "d": ("mlp",),
                  "w_out": ("mlp", "embed")}}


def init_mamba(gen: torch.Generator, cfg: ModelConfig, plan: ShardPlan,
               device, dtype=torch.float32) -> nn.ParameterDict:
    d, di, n = cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state
    dr, kc = cfg.dt_rank, cfg.mamba_d_conv
    f32 = torch.float32
    # S4D-real initialization for A; dt_bias = softplus^-1(U(1e-3, 1e-1))
    a = torch.arange(1, n + 1, dtype=f32, device=device).expand(di, n)
    dt = 1e-3 + (1e-1 - 1e-3) * torch.rand((di,), generator=gen,
                                             device=device, dtype=f32)
    return param_group(
        w_in=dense_init(gen, d, 2 * di, device, dtype),
        conv_w=normal(gen, (kc, di), (1 / kc) ** 0.5, device, dtype),
        conv_b=torch.zeros((di,), dtype=dtype, device=device),
        w_x=dense_init(gen, di, dr + 2 * n, device, dtype),
        w_dt=dense_init(gen, dr, di, device, dtype),
        dt_bias=torch.log(torch.expm1(dt)),
        a_log=torch.log(a).contiguous(),
        d=torch.ones((di,), dtype=f32, device=device),
        w_out=dense_init(gen, di, d, device, dtype))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: torch.Tensor | None = None):
    """Depthwise causal conv1d. x [B,S,di]; w [K,di]; b [di]. Returns
    (y [B,S,di], new conv state [B,K-1,di]), summing the taps in order
    from the oldest as the reference does."""
    k, s = w.shape[0], x.shape[1]
    if conv_state is None:
        conv_state = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)      # [B,S+K-1,di]
    y = xp[:, 0:s] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i]
    return y + b, xp[:, xp.shape[1] - (k - 1):]


def mamba_block(p, cfg: ModelConfig, plan: ShardPlan, x: torch.Tensor,
                state, impl: str = "kernel"):
    """x [B,S,d]; state = (conv_state [B,K-1,di], h [B,di,n] float32).
    Returns (out [B,S,d], (conv_state, h_T))."""
    xc, z, conv_state, xdbc = mamba_in(p, x, state[0])
    out, h_new = mamba_out(p, cfg, xc, z, xdbc, state[1], impl)
    return out, (conv_state, h_new)


def mamba_in(p, x: torch.Tensor, conv_state: torch.Tensor):
    """The block up to ``w_x``: (xc [B,S,di], z [B,S,di], the new conv
    state, xdbc [B,S,dr+2n]). ``w_in``'s ``xin`` and ``z`` halves are two
    products: a model shard passes its ``di/m`` columns of each as a pair
    of views (``launch.specs``' ``PARTS``), its ``mlp`` block of the conv
    and its rows of ``w_x``, and xdbc is then its partial sum."""
    w = p["w_in"]
    w_xin, w_z = w if isinstance(w, tuple) else w.chunk(2, dim=-1)
    xin, z = dense(w_xin, x), dense(w_z, x)                  # [B,S,di] x 2
    xc, conv_state = _causal_conv(xin, p["conv_w"].to(x.dtype),
                                  p["conv_b"].to(x.dtype), conv_state)
    xc = F.silu(xc)
    return xc, z, conv_state, dense(p["w_x"], xc)


def mamba_out(p, cfg: ModelConfig, xc: torch.Tensor, z: torch.Tensor,
              xdbc: torch.Tensor, h0: torch.Tensor, impl: str = "kernel"):
    """The block from the summed xdbc on: dt, the selective scan (kernel
    7 for ``impl="kernel"``) from ``h0`` over xc's channels, the gate and
    ``w_out``. Returns (out [B,S,d], h_T); on a model shard out is its
    partial sum."""
    check_impl(impl)
    n, dr = cfg.mamba_d_state, cfg.dt_rank
    f32 = torch.float32
    dt_r, b_in, c_in = xdbc.split([dr, n, n], dim=-1)
    pre = dense(p["w_dt"], dt_r).float() + p["dt_bias"].float()
    delta = torch.logaddexp(pre, torch.zeros((), dtype=f32,
                                             device=xc.device))  # softplus
    a = -torch.exp(p["a_log"].float())                       # [di,n] (<0)
    # on meta tensors both take the kernel's meta route: the plain
    # recurrence would loop once per token
    run = scan_ops.mamba_scan if impl == "kernel" or xc.is_meta \
        else mamba_scan_ref
    y, h_new = run(xc.to(f32), delta, a, b_in.to(f32), c_in.to(f32),
                   p["d"].float(), h0.float())
    y = y.to(xc.dtype) * F.silu(z)
    return dense(p["w_out"], y), h_new


def init_mamba_state(cfg: ModelConfig, batch: int, dtype, device) -> tuple:
    """(conv state [B,K-1,di] in ``dtype``, h [B,di,n] float32), zero."""
    return (torch.zeros((batch, cfg.mamba_d_conv - 1, cfg.mamba_d_inner),
                        dtype=dtype, device=device),
            torch.zeros((batch, cfg.mamba_d_inner, cfg.mamba_d_state),
                        dtype=torch.float32, device=device))


