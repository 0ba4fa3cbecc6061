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
On a model mesh, :func:`moe_mesh` is the reference's ``moe``:
:func:`apply_moe_shardmap` (the expert-parallel dispatch with two
all-to-alls over ``model``) where its conditions hold, else ``apply_moe``
over the whole batch (:func:`apply_moe_mesh`), both built from the pieces
of :func:`apply_moe`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.common import dense, dense_init, normal, param_group
from repro_torch.sharding.rules import ShardPlan
from repro_torch.utils import round_up

# logical axes of each group's leaves (``sharding.axes.logical_axes``), as
# the reference's ``init_mlp`` / ``init_moe`` annotate them; the MoE's
# ``shared`` group is an MLP
AXES = {"mlp": {"w_up": ("embed", "mlp"), "w_down": ("mlp", "embed"),
                "w_gate": ("embed", "mlp")},
        "moe": {"router": ("embed", "expert"),
                "w_gate": ("expert", None, None),
                "w_up": ("expert", None, None),
                "w_down": ("expert", None, None)}}


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


def moe_aux(cfg: ModelConfig, e_pad: int, probs: torch.Tensor,
            tope: torch.Tensor) -> torch.Tensor:
    """The Switch-style load-balancing loss over the real experts: ``E``
    times the sum over experts of (share of the ``N * K`` choices) times
    (mean router probability)."""
    n, k = tope.shape
    load = torch.zeros((e_pad,), dtype=torch.float32, device=probs.device)
    load.index_add_(0, tope.reshape(-1),
                    torch.ones(n * k, dtype=torch.float32,
                               device=probs.device))
    return cfg.n_experts * torch.sum(load / (n * k) * probs.mean(0))


def moe_dispatch(xf: torch.Tensor, topw: torch.Tensor, tope: torch.Tensor,
                 cap: int, e_pad: int) -> tuple:
    """The sort-based dispatch of ``xf [N, d]``'s top-k choices: the
    (token, choice) pairs sorted stably by expert, ranked within their
    expert, those ranked at or beyond ``cap`` dropped, the rest copied into
    their ``[E, cap, d]`` slots. Returns ``(buf, route)``; ``route`` (the
    kept pairs' expert, token, weight, rank, and their place among the
    token's experts in ascending order) is what :func:`moe_gather` reads
    back."""
    n, k = tope.shape
    ek = tope.reshape(n * k)
    order = torch.sort(ek, stable=True).indices
    se = ek[order]
    stok = torch.div(order, k, rounding_mode="floor")
    sw = topw.reshape(n * k)[order]
    first = torch.searchsorted(se, se, side="left")
    rank = torch.arange(n * k, device=xf.device) - first
    keep = torch.nonzero(rank < cap).flatten()               # capacity drop
    se, stok, sw, rank = se[keep], stok[keep], sw[keep], rank[keep]
    buf = xf.new_zeros((e_pad, cap, xf.shape[1]))
    buf[se, rank] = xf[stok]                                 # distinct slots
    # each kept pair's place in its token's experts' ascending order (a
    # token's experts are distinct)
    by_expert = (tope[:, None, :] < tope[:, :, None]).sum(-1).reshape(n * k)
    return buf, (se, stok, sw, rank, by_expert[order[keep]])


def expert_ffn(buf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor) -> torch.Tensor:
    """Each expert's SwiGLU on its block: ``buf [E, cap, d]`` with
    ``w_gate``/``w_up`` ``[E, d, h]`` and ``w_down`` ``[E, h, d]`` (the
    three per-expert products as ``torch.bmm``, as the reference leaves
    its einsums to XLA)."""
    dt = buf.dtype
    hh = F.silu(torch.bmm(buf, w_gate.to(dt))) * torch.bmm(
        buf, w_up.to(dt))                                    # [E, cap, h]
    return torch.bmm(hh, w_down.to(dt))                      # [E, cap, d]


def moe_gather(out_buf: torch.Tensor, route: tuple, n: int, k: int
               ) -> torch.Tensor:
    """``[N, d]``: each token's kept expert outputs weighted, placed at
    their place among its experts, dropped ones zero, then summed by
    :func:`combine`."""
    se, stok, sw, rank, place = route
    terms = out_buf.new_zeros((n, k, out_buf.shape[2]))
    terms[stok, place] = out_buf[se, rank] * sw[:, None].to(out_buf.dtype)
    return combine(terms)


def apply_moe(p, cfg: ModelConfig, plan: ShardPlan, x: torch.Tensor):
    """x [B,S,d] -> (out [B,S,d], aux_loss float32 scalar)."""
    b, s, d = x.shape
    n = b * s
    e_pad = plan.n_experts_padded or cfg.n_experts
    xf = x.reshape(n, d)
    probs, topw, tope = moe_route(p, cfg, plan, xf)
    aux = moe_aux(cfg, e_pad, probs, tope)
    buf, route = moe_dispatch(xf, topw, tope, capacity(cfg, n), e_pad)
    out_buf = expert_ffn(buf, p["w_gate"], p["w_up"], p["w_down"])
    out = moe_gather(out_buf, route, n, cfg.moe_top_k).reshape(b, s, d)
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
    """The MoE dispatcher on one device: ``apply_moe``, whatever the plan.
    The reference's ``moe`` takes ``apply_moe_shardmap``, which falls back
    to ``apply_moe`` without mesh rules and crashes with a mesh plan used
    off a mesh (``KeyError: 'data'``); on a ``ModelMesh`` the port's
    expert-parallel dispatch is ``models.parallel.moe``."""
    return apply_moe(p, cfg, plan, x)


# -- on a model mesh (models/parallel.py) -------------------------------------

def moe_mesh(ps: list, cfg: ModelConfig, plan: ShardPlan, lay, xs: list
             ) -> tuple:
    """The reference's ``moe`` on a ``ModelMesh``: ``ps`` each shard's
    ``moe`` group, ``xs`` the stream in ``lay``'s layout (a
    ``parallel.Layout``). :func:`apply_moe_shardmap` when the rules put
    ``seq_sp`` on ``model``, ``model`` divides the sequence and the batch
    axes divide the batch; else (decode, a ragged prefill, a batch of 1
    over two data shards) :func:`apply_moe_mesh`, the reference's
    fallbacks. The shared experts' SwiGLU is added after, sharded on
    ``mlp``. Returns (outs in the stream's layout, aux)."""
    rules, m = plan.rules_dict, plan.model_size
    dp_total = lay.mesh.extent(plan.batch_axes)
    if rules is None or rules.get("seq_sp") != "model" or \
            lay.seq % m != 0 or lay.batch % dp_total != 0:
        ys, aux = apply_moe_mesh(ps, cfg, plan, lay, xs)
    else:
        ys, aux = apply_moe_shardmap(ps, cfg, plan, lay, xs)
    if "shared" in ps[0]:
        hf = lay.gather_seq(xs)
        sh = lay.reduce([apply_mlp(p["shared"], h, "swiglu")
                         for p, h in zip(ps, hf)])
        ys = mesh_mod.replicated(torch.add, ys, sh)
    return ys, aux


def _router(ps: list, lay) -> list:
    """The whole router ``[d, E]`` on every shard (its ``expert`` columns
    gathered over ``model``)."""
    return mesh_mod.collective("all_gather", [p["router"] for p in ps],
                               lay.mesh, "model", dim=1)


def apply_moe_shardmap(ps: list, cfg: ModelConfig, plan: ShardPlan, lay,
                       xs: list) -> tuple:
    """The reference's ``apply_moe_shardmap``, shard by shard, on the
    sequence-parallel stream: each (data, model) shard routes its own
    ``N_l`` tokens (top-k, ``apply_moe``'s aux over them, averaged over
    ``model``) and dispatches them into an ``[E, cap, d]`` buffer with
    the local capacity ``round_up(max(int(n_loc * k * cf) // E, 1), 8)``,
    ``n_loc = (B / dp) * (S / m)``; an ``all_to_all`` over ``model`` sends
    each expert block to the shard that holds the expert (``[E/m, m * cap,
    d]``), which runs its SwiGLU; the reverse ``all_to_all`` brings the
    outputs home and each token adds its kept experts' weighted outputs.
    The aux loss is the mean over the shards."""
    mesh = lay.mesh
    e_pad = plan.n_experts_padded or cfg.n_experts
    dp_total = mesh.extent(plan.batch_axes)
    n_loc = (lay.batch // dp_total) * (lay.seq // plan.model_size)
    cap = capacity(cfg, n_loc)
    routers = _router(ps, lay)
    bufs, routes, auxs = [], [], []
    for x, r in zip(xs, routers):
        xf = x.reshape(-1, x.shape[-1])
        probs, topw, tope = moe_route({"router": r}, cfg, plan, xf)
        auxs.append(moe_aux(cfg, e_pad, probs, tope))
        buf, route = moe_dispatch(xf, topw, tope, cap, e_pad)
        bufs.append(buf)
        routes.append(route)
    auxs = mesh_mod.collective("all_reduce", auxs, mesh, "model")
    recv = mesh_mod.collective("all_to_all", bufs, mesh, "model", dim=0,
                               concat_dim=1)
    outs = [expert_ffn(b, p["w_gate"], p["w_up"], p["w_down"])
            for b, p in zip(recv, ps)]
    back = mesh_mod.collective("all_to_all", outs, mesh, "model", dim=1,
                               concat_dim=0)
    ys = [moe_gather(o, route, x.shape[0] * x.shape[1], cfg.moe_top_k
                     ).reshape(x.shape)
          for o, route, x in zip(back, routes, xs)]
    home = mesh.devices[0]
    aux = sum(a.to(home) for a in auxs) / plan.model_size / mesh.size
    return ys, aux


def apply_moe_mesh(ps: list, cfg: ModelConfig, plan: ShardPlan, lay,
                   xs: list) -> tuple:
    """``apply_moe`` over the whole batch on the mesh: every shard
    gathers every token, routes and dispatches them as ``apply_moe`` does
    (capacity from all ``B * S`` tokens), runs its own experts' block of
    the buffer; the blocks are gathered over ``model`` and each shard
    keeps its rows and positions of the combine. Shards that hold the
    same gathered tokens and router (one device of a virtual mesh) route
    and combine once."""
    mesh = lay.mesh
    e_pad = plan.n_experts_padded or cfg.n_experts
    xg = lay.gather_rows(lay.gather_seq(xs))
    routers = _router(ps, lay)
    n = xg[0].shape[0] * xg[0].shape[1]
    cap = capacity(cfg, n)

    def route(x, r):
        xf = x.reshape(n, x.shape[-1])
        probs, topw, tope = moe_route({"router": r}, cfg, plan, xf)
        return moe_aux(cfg, e_pad, probs, tope), moe_dispatch(
            xf, topw, tope, cap, e_pad)
    routed = mesh_mod.replicated(route, xg, routers)
    outs = []
    for s, (p, (_, (buf, _))) in enumerate(zip(ps, routed)):
        e_l = p["w_gate"].shape[0]
        j = lay.j(s)
        outs.append(expert_ffn(buf[j * e_l:(j + 1) * e_l], p["w_gate"],
                               p["w_up"], p["w_down"]))
    full = mesh_mod.collective("all_gather", outs, mesh, "model", dim=0)

    def combine_rows(o, rt, x, rows, cols):
        y = moe_gather(o, rt, n, cfg.moe_top_k).reshape(x.shape)[rows]
        return y[:, cols] if lay.sp else y
    ys = mesh_mod.replicated(
        combine_rows, full, [rt[1][1] for rt in routed], xg,
        [lay.rows(s) for s in range(mesh.size)],
        [lay.cols(s) for s in range(mesh.size)])
    return ys, routed[0][0].to(mesh.devices[0])
