"""MLPs: SwiGLU / GELU dense blocks and sort-based Mixture-of-Experts.

Counterpart of ``repro/models/mlp.py``. The MoE is the path the reference
takes on one device (``moe`` -> ``apply_moe_shardmap``, which falls back
to ``apply_moe`` when the plan has no mesh rules): softmax router in
float32, top-k with ``lax.top_k``'s tie order (the lower expert first),
weights renormalised, then the sort-based dispatch: the (token, choice)
pairs sorted stably by expert, ranked within their expert, the pairs
ranked at or beyond the capacity dropped, the rest gathered into an
``[E, cap, d]`` buffer, run through the three per-expert products
(``torch.bmm``, as the reference leaves its einsums to XLA), and added
back to their tokens weighted, in a fixed order (:func:`combine`); the
shared experts' dense SwiGLU output (Moonlight's) is added after that sum.
The expert-parallel all-to-all of the mesh path has no counterpart on one
card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense, dense_init, normal, param_group
from repro_torch.sharding.rules import ShardPlan
from repro_torch.utils import round_up


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


# -- Mixture of Experts --------------------------------------------------------

def init_moe(gen: torch.Generator, cfg: ModelConfig, plan: ShardPlan,
             device, dtype=torch.float32) -> nn.ParameterDict:
    """Router ``[d, E]`` and expert weights ``w_gate``/``w_up`` ``[E, d,
    h]``, ``w_down`` ``[E, h, d]``, all ``N(0, 1/d)`` as the reference
    draws them, then, where the config has shared experts, their dense
    SwiGLU group ``shared`` of width ``n_shared_experts * moe_d_ff``
    (:func:`init_mlp`)."""
    d, h = cfg.d_model, cfg.moe_d_ff
    e = plan.n_experts_padded or cfg.n_experts
    scale = (1.0 / d) ** 0.5
    p = {"router": dense_init(gen, d, e, device, dtype),
         "w_gate": normal(gen, (e, d, h), scale, device, dtype),
         "w_up": normal(gen, (e, d, h), scale, device, dtype),
         "w_down": normal(gen, (e, h, d), scale, device, dtype)}
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, d, cfg.n_shared_experts * h, "swiglu",
                               device, dtype)
    return param_group(**p)


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert for ``n_tokens`` tokens (the reference's formula:
    ``round_up(max(int(n * k * capacity_factor) // E, 1), 8)``)."""
    k, e = cfg.moe_top_k, cfg.n_experts
    return round_up(max(int(n_tokens * k * cfg.capacity_factor) // e, 1), 8)


def moe_route(p, cfg: ModelConfig, plan: ShardPlan, xf: torch.Tensor):
    """Router of ``xf [N, d]``: (probs [N, E] float32, top-k weights
    [N, K] renormalised, top-k experts [N, K] int64). The top k are taken
    by a stable descending sort, so equal probabilities go to the lower
    expert first, as ``lax.top_k`` orders them."""
    e_pad = plan.n_experts_padded or cfg.n_experts
    logits = dense(p["router"], xf).float()                  # [N, E]
    if e_pad != cfg.n_experts:
        pad = torch.arange(e_pad, device=xf.device) >= cfg.n_experts
        logits = logits.masked_fill(pad, -1e30)
    probs = torch.softmax(logits, dim=-1)
    topw, tope = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, tope = topw[:, :cfg.moe_top_k], tope[:, :cfg.moe_top_k]
    topw = topw / topw.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, topw, tope


def apply_moe(p, cfg: ModelConfig, plan: ShardPlan, x: torch.Tensor):
    """x [B,S,d] -> (out [B,S,d], aux_loss float32 scalar)."""
    b, s, d = x.shape
    n = b * s
    e_pad = plan.n_experts_padded or cfg.n_experts
    k = cfg.moe_top_k
    xf = x.reshape(n, d)
    probs, topw, tope = moe_route(p, cfg, plan, xf)

    # load-balancing aux loss (Switch-style), over real experts
    load = torch.zeros((e_pad,), dtype=torch.float32, device=x.device)
    load.index_add_(0, tope.reshape(-1),
                    torch.ones(n * k, dtype=torch.float32, device=x.device))
    aux = cfg.n_experts * torch.sum(load / (n * k) * probs.mean(0))

    # sort-based dispatch: stable by expert, ranked within the expert
    cap = capacity(cfg, n)
    ek = tope.reshape(n * k)
    order = torch.sort(ek, stable=True).indices
    se = ek[order]
    stok = torch.div(order, k, rounding_mode="floor")
    sw = topw.reshape(n * k)[order]
    first = torch.searchsorted(se, se, side="left")
    rank = torch.arange(n * k, device=x.device) - first
    keep = torch.nonzero(rank < cap).flatten()               # capacity drop
    se, stok, sw, rank = se[keep], stok[keep], sw[keep], rank[keep]
    buf = x.new_zeros((e_pad, cap, d))
    buf[se, rank] = xf[stok]                                 # distinct slots
    dt = x.dtype
    hh = F.silu(torch.bmm(buf, p["w_gate"].to(dt))) * torch.bmm(
        buf, p["w_up"].to(dt))                               # [E, cap, h]
    out_buf = torch.bmm(hh, p["w_down"].to(dt))              # [E, cap, d]
    # the combine: each token's kept terms at their place in its experts'
    # ascending order (a token's experts are distinct), dropped ones zero
    by_expert = (tope[:, None, :] < tope[:, :, None]).sum(-1).reshape(n * k)
    terms = x.new_zeros((n, k, d))
    terms[stok, by_expert[order[keep]]] = out_buf[se, rank] * sw[:, None].to(dt)
    out = combine(terms).reshape(b, s, d)
    if "shared" in p:                   # after the routed sum, as there
        out = out + apply_mlp(p["shared"], x, "swiglu")
    return out, aux


def combine(terms: torch.Tensor) -> torch.Tensor:
    """``terms [N, K, d]`` -> ``[N, d]``: from zero, add ``terms[:, j]``
    for ``j = 0 .. K-1`` in turn, each sum rounded to the terms' dtype.

    The order the reference's scatter-add (``y.at[stok].add``) takes on
    the CPU, where the pairs arrive stably sorted by expert: each token's
    terms in ascending expert order. Plain elementwise adds, with no
    atomics, so a run on the card repeats itself bit for bit; a dropped
    term is ``+0.0``, which leaves a sum from ``+0.0`` unchanged.
    """
    y = torch.zeros_like(terms[:, 0])
    for j in range(terms.shape[1]):
        y = y + terms[:, j]
    return y


def moe(p, cfg: ModelConfig, plan: ShardPlan, x: torch.Tensor):
    """The MoE dispatcher: on one device the reference's ``moe`` runs
    ``apply_moe`` (its plan has no mesh rules), and so does this."""
    return apply_moe(p, cfg, plan, x)
