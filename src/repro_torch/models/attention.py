"""Grouped-query and multi-head latent attention, full-sequence (prefill)
and paged decode.

Counterpart of ``repro/models/attention.py``'s GQA (``init_gqa``,
``_head_mask``, ``_gqa_qkv`` with qk-norm, ``gqa_full``,
``gqa_decode_paged``) and MLA (``init_mla``, ``_mla_qkv``, ``mla_full``,
``mla_absorbed_parts``, ``mla_absorbed_out``, and the latent-page decode of
``repro/serve/paged_lm.py::_mla_paged``), and Whisper's cross-attention
(``cross_kv``, ``cross_full``).

Decode has one body per mixer, the paged one. The reference's dense-cache
decode (``gqa_decode``, ``decode_attn_stacked``,
``mla_decode_absorbed_stacked``: ``_sdpa`` over the whole cache masked to
``kpos <= pos``) runs here through the same paged kernel with no copy: a
layer's dense cache ``[B, Smax, Hkv, d]`` is already paged, one page of
``Smax`` slots a sequence, block table ``[[0], [1], ..., [B-1]]`` and the
window ``0 <= slot <= pos`` (:func:`dense_window`). Whisper's
cross-attention at decode reads its ``[B, enc_seq, Hkv, dh]`` cross cache
the same way with the window ``0 <= slot < enc_seq``
(:func:`cross_decode`).

MLA caches the absorbed form: per token one latent ``[kv_lora]`` and one
roped key ``[qk_rope]`` shared by every head, so its pages hold one "KV
head" of keys ``latent (+) rope`` and values ``latent``, and decode runs
the paged kernel unchanged with ``Hkv = 1``, ``g = Hq``. Its prefill runs
the expanded per-head q, k, v through the flash kernel: where the value
head is narrower than the query/key head (64 against 96 in MiniCPM3), V
is zero-padded to the key width and the padding columns of the output
dropped, which is exact (a zero column of V gives a zero output column).
The reference computes that attention with its XLA ``_sdpa`` whatever its
``impl``; the absorbed einsums stay plain products here as there.

On a model mesh (``models/parallel.py``) each shard calls these with its
weight slices and its first q head ``head0``: head counts come from the
weights' shapes, the head mask from ``head0``, and ``wo``'s rows give the
shard's partial sum. Where KV heads do not shard, :func:`shard_kv` cuts
or repeats a shard's KV to its q heads in prefill, and decode runs the
mesh-level :func:`decode_attn_kv_dh` (the cache on ``head_dim``) or, under
rules that map ``kv_seq`` to ``model``, :func:`decode_attn_seqshard`.

``impl`` picks the attention arithmetic:
  * ``"kernel"`` (default): the ops entry points, which dispatch by device,
    so the hand-written kernels run on the card (``ops.flash_attention``
    on ``[B,H,S,dh]`` as the reference's ``gqa_full(impl="pallas")``
    does, ``ops.paged_attention``) and the plain versions on the CPU;
  * ``"ref"``: the plain versions on any device, named by callers that
    hold the kernels against them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import mha_ref
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.models.common import (
    apply_rope,
    dense,
    dense_init,
    param_group,
    rms_norm_1d,
)
from repro_torch.sharding.rules import ShardPlan

IMPLS = ("kernel", "ref")


def check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}: want one of {IMPLS}")


# logical axes of each group's leaves (``sharding.axes.logical_axes``),
# as the reference's ``init_gqa`` / ``init_mla`` annotate them
GQA_AXES = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
            "wv": ("embed", "kv_heads"), "wo": ("heads", "embed"),
            "q_norm": (None,), "k_norm": (None,)}
MLA_AXES = {"w_dq": ("embed", "q_lora"), "w_uq": ("q_lora", "heads"),
            "w_dkv": ("embed", "kv_lora"), "w_ukv": ("kv_lora", "heads"),
            "wo": ("heads", "embed"), "q_ln": (None,), "kv_ln": (None,)}
AXES = {"attn": {**GQA_AXES, **MLA_AXES}, "xattn": GQA_AXES}


def _head_mask(plan: ShardPlan, n_real: int, device=None, head0: int = 0,
               n: int | None = None) -> torch.Tensor:
    """[n] 1.0 for real heads, 0.0 for padding heads: heads ``head0 ..
    head0 + n - 1`` of the plan's ``n_heads_padded`` (default all of
    them; a model shard passes its own)."""
    n = plan.n_heads_padded if n is None else n
    return (torch.arange(head0, head0 + n, device=device) < n_real
            ).to(torch.float32)


def _maybe_repeat_kv(plan: ShardPlan, g: int) -> bool:
    """Whether the plan's prefill repeats each KV head ``g`` times (the
    reference's ``_maybe_repeat_kv``): where KV heads are replicated and
    their count neither divides nor is divided by the model axis
    (Phi-3-medium's 12 against 16), so that the repeated KV shards by q
    head. The repeat changes no number: each q head reads its group's
    head either way."""
    hkv, m = plan.n_kv_heads_padded, plan.model_size
    return not (m == 1 or plan.kv_sharded or g == 1
                or m % hkv == 0 or hkv % m == 0)


def shard_kv(k: torch.Tensor, v: torch.Tensor, plan: ShardPlan,
             head0: int, n_q: int) -> tuple:
    """The KV heads q heads ``head0 .. head0 + n_q - 1`` read, from k, v
    ``[B,S,Hkv',dh]`` as a model shard computed them: its own slice where
    the plan shards KV heads (returned as they are), else all of them.
    Replicated KV is repeated to one head per q head where
    :func:`_maybe_repeat_kv` says so, else cut to the heads of the
    shard's groups (the shard's q heads lie in whole groups, or in one:
    ``m % Hkv == 0``). One device (``head0 = 0``, every q head) keeps
    them all."""
    hkv, g = plan.n_kv_heads_padded, plan.group_size
    if k.shape[2] != hkv or n_q == plan.n_heads_padded:
        return k, v
    if _maybe_repeat_kv(plan, g):
        sel = torch.arange(head0, head0 + n_q, device=k.device) // g
        return k.index_select(2, sel), v.index_select(2, sel)
    lo, hi = head0 // g, -(-(head0 + n_q) // g)
    return k[:, :, lo:hi], v[:, :, lo:hi]


def init_gqa(gen: torch.Generator, cfg: ModelConfig, plan: ShardPlan,
             device, dtype=torch.float32) -> nn.ParameterDict:
    d, dh = cfg.d_model, cfg.head_dim
    hq, hkv = plan.n_heads_padded, plan.n_kv_heads_padded
    p = {"wq": dense_init(gen, d, hq * dh, device, dtype),
         "wk": dense_init(gen, d, hkv * dh, device, dtype),
         "wv": dense_init(gen, d, hkv * dh, device, dtype),
         "wo": dense_init(gen, hq * dh, d, device, dtype)}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), dtype=torch.float32, device=device)
        p["k_norm"] = torch.ones((dh,), dtype=torch.float32, device=device)
    return param_group(**p)


def _gqa_qkv(p, cfg: ModelConfig, plan: ShardPlan, x: torch.Tensor,
             positions: torch.Tensor, rope: bool = True):
    """x [B,S,d] -> q [B,S,Hq,dh], k and v [B,S,Hkv,dh]; the head counts
    are the weights' (a model shard's slice holds its own)."""
    b, s, _ = x.shape
    dh = cfg.head_dim
    hq, hkv = p["wq"].shape[1] // dh, p["wk"].shape[1] // dh
    q = dense(p["wq"], x).reshape(b, s, hq, dh)
    k = dense(p["wk"], x).reshape(b, s, hkv, dh)
    v = dense(p["wv"], x).reshape(b, s, hkv, dh)
    if cfg.qk_norm:
        q = rms_norm_1d(q, p["q_norm"])
        k = rms_norm_1d(k, p["k_norm"])
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_full(p, cfg: ModelConfig, plan: ShardPlan, x: torch.Tensor,
             positions: torch.Tensor, causal: bool = True,
             impl: str = "kernel", head0: int = 0):
    """Full-sequence attention. Returns (out [B,S,d], (k, v) for caching,
    each [B,S,Hkv,dh]). A model shard passes its weight slices and its
    first q head ``head0``: out is then its partial sum, which the model
    axis adds up, and k, v the KV heads it computed (before
    :func:`shard_kv`)."""
    check_impl(impl)
    b, s, _ = x.shape
    q, k, v = _gqa_qkv(p, cfg, plan, x, positions)
    hq = q.shape[2]
    ka, va = shard_kv(k, v, plan, head0, hq)
    attend = flash_ops.flash_attention if impl == "kernel" else mha_ref
    o = attend(q.transpose(1, 2).contiguous(),
               ka.transpose(1, 2).contiguous(),
               va.transpose(1, 2).contiguous(), causal=causal).transpose(1, 2)
    o = o * _head_mask(plan, cfg.n_heads, x.device, head0, hq)[
        None, None, :, None].to(o.dtype)
    return dense(p["wo"], o.reshape(b, s, -1)), (k, v)


def paged_write_rows(tables: torch.Tensor, lengths: torch.Tensor,
                     starts: torch.Tensor, page: int):
    """Where each sequence's new token goes: ``(rows, pages, slots)`` of the
    rows that write. A row writes when the table entry of its slot
    ``lengths // page`` holds a page and its window is not past its end
    (``lengths >= starts``); the reference sends the other rows to a
    dropped index. Sequences never share a page, so the targets are
    distinct. Same for every layer: compute it once per decode step."""
    b = tables.shape[0]
    pslot = (lengths // page).clamp(0, tables.shape[1] - 1).long()
    pidx = tables[torch.arange(b, device=tables.device), pslot]
    ok = (pidx >= 0) & (lengths >= starts)
    rows = torch.nonzero(ok).flatten()
    return rows, pidx[rows].long(), (lengths[rows] % page).long()


def gqa_decode_paged(p, cfg: ModelConfig, plan: ShardPlan, x: torch.Tensor,
                     k_pages: torch.Tensor, v_pages: torch.Tensor,
                     tables: torch.Tensor, lengths: torch.Tensor,
                     starts: torch.Tensor, positions: torch.Tensor,
                     write: tuple, impl: str = "kernel", head0: int = 0):
    """One-token decode over the slab-paged KV cache.

    x [B,1,d]; k_pages/v_pages [n_pages, page, Hkv, dh] (one layer's pool,
    updated in place: the new token's K/V go into their page slot, a
    masked write of the rows that write); tables [B, maxp] int32;
    lengths/starts [B] int32 cache-coordinate window; positions [B]
    absolute positions for RoPE; ``write`` the step's
    :func:`paged_write_rows`. Returns (out [B,1,d], k_pages, v_pages).
    A model shard whose KV heads are its own (``kv_sharded``) passes its
    weight slices, its pools and ``head0`` (see :func:`gqa_full`).
    """
    check_impl(impl)
    b = x.shape[0]
    q, k_new, v_new = _gqa_qkv(p, cfg, plan, x, positions[:, None])
    rows, pages, slots = write
    k_pages[pages, slots] = k_new[rows, 0].to(k_pages.dtype)
    v_pages[pages, slots] = v_new[rows, 0].to(v_pages.dtype)
    attend = paged_ops.paged_attention if impl == "kernel" \
        else paged_attention_ref
    o = attend(q[:, 0].contiguous(), k_pages, v_pages, tables, lengths + 1,
               starts)
    o = o * _head_mask(plan, cfg.n_heads, x.device, head0, q.shape[2])[
        None, :, None].to(o.dtype)
    return dense(p["wo"], o.reshape(b, 1, -1)), k_pages, v_pages


# ---------------------------------------------------------------------------
# MLA (minicpm3): multi-head latent attention
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg: ModelConfig, plan: ShardPlan,
             device, dtype=torch.float32) -> nn.ParameterDict:
    """``w_dq``, ``w_uq``, ``w_dkv``, ``w_ukv``, ``wo`` in the reference's
    order and shapes, and the float32 latent norms ``q_ln``, ``kv_ln``."""
    d, hq = cfg.d_model, plan.n_heads_padded
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    return param_group(
        w_dq=dense_init(gen, d, cfg.q_lora_rank, device, dtype),
        w_uq=dense_init(gen, cfg.q_lora_rank, hq * qk, device, dtype),
        w_dkv=dense_init(gen, d, cfg.kv_lora_rank + cfg.qk_rope_dim, device,
                         dtype),
        w_ukv=dense_init(gen, cfg.kv_lora_rank,
                         hq * (cfg.qk_nope_dim + cfg.v_head_dim), device,
                         dtype),
        wo=dense_init(gen, hq * cfg.v_head_dim, d, device, dtype),
        q_ln=torch.ones((cfg.q_lora_rank,), dtype=torch.float32,
                        device=device),
        kv_ln=torch.ones((cfg.kv_lora_rank,), dtype=torch.float32,
                         device=device))


def _mla_query(p, cfg: ModelConfig, plan: ShardPlan, x: torch.Tensor,
               positions: torch.Tensor):
    """x [B,S,d] -> (q_nope [B,S,H,nope], q_rope [B,S,H,rope] roped)."""
    b, s, _ = x.shape
    nope = cfg.qk_nope_dim
    cq = rms_norm_1d(dense(p["w_dq"], x), p["q_ln"])
    q = dense(p["w_uq"], cq).reshape(b, s, -1, nope + cfg.qk_rope_dim)
    return q[..., :nope], apply_rope(q[..., nope:], positions,
                                     cfg.rope_theta)


def _mla_latent(p, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor):
    """x [B,S,d] -> (normed latent [B,S,kv_lora], roped key [B,S,rope]):
    what a token leaves in the cache."""
    b, s, _ = x.shape
    lat = cfg.kv_lora_rank
    ckv = dense(p["w_dkv"], x)                               # [B,S,lat+rope]
    c_lat = rms_norm_1d(ckv[..., :lat], p["kv_ln"])
    k_rope = apply_rope(ckv[..., lat:].reshape(b, s, 1, cfg.qk_rope_dim),
                        positions, cfg.rope_theta)[:, :, 0]
    return c_lat, k_rope


def _w_ukv(p, cfg: ModelConfig, hq: int, dtype) -> tuple:
    """``w_ukv`` as (W_k [lat, H, nope], W_v [lat, H, v_head]) in
    ``dtype``."""
    nope = cfg.qk_nope_dim
    w = p["w_ukv"].reshape(cfg.kv_lora_rank, hq, nope + cfg.v_head_dim)
    return w[..., :nope].to(dtype), w[..., nope:].to(dtype)


def _mla_qkv(p, cfg: ModelConfig, plan: ShardPlan, x: torch.Tensor,
             positions: torch.Tensor):
    """The expanded per-head operands: q, k [B,S,H,nope+rope] (the roped
    key broadcast to every head), v [B,S,H,v_head]; and the cache entries
    ``(latent, rope key)``."""
    b, s, _ = x.shape
    nope, rp = cfg.qk_nope_dim, cfg.qk_rope_dim
    q_nope, q_rope = _mla_query(p, cfg, plan, x, positions)
    hq = q_nope.shape[2]
    c_lat, k_rope = _mla_latent(p, cfg, x, positions)
    kv = dense(p["w_ukv"], c_lat).reshape(b, s, hq, nope + cfg.v_head_dim)
    k = torch.cat([kv[..., :nope],
                   k_rope[:, :, None].expand(b, s, hq, rp)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    return q, k, kv[..., nope:], (c_lat, k_rope)


def mla_full(p, cfg: ModelConfig, plan: ShardPlan, x: torch.Tensor,
             positions: torch.Tensor, causal: bool = True,
             impl: str = "kernel", head0: int = 0):
    """Full-sequence MLA. Returns (out [B,S,d], (latent [B,S,kv_lora],
    rope key [B,S,rope])): the absorbed form, which the paged engine's
    latent pages take directly.

    The attention runs on ``[B,H,S,w]`` operands of one width ``w =
    max(qk_head_dim, v_head_dim)``, the narrower zero-padded, with
    ``scale = qk_head_dim ** -0.5``: the flash kernel (TPU kernel 6) for
    ``impl="kernel"``, ``mha_ref`` for ``"ref"``. A model shard passes
    its weight slices and ``head0``, as to :func:`gqa_full`."""
    check_impl(impl)
    b, s, _ = x.shape
    vh = cfg.v_head_dim
    q, k, v, cache = _mla_qkv(p, cfg, plan, x, positions)
    hq = q.shape[2]
    w = max(q.shape[-1], vh)
    q, k, v = (F.pad(a, (0, w - a.shape[-1])).transpose(1, 2).contiguous()
               for a in (q, k, v))
    attend = flash_ops.flash_attention if impl == "kernel" else mha_ref
    o = attend(q, k, v, causal=causal,
               scale=cfg.qk_head_dim ** -0.5)[..., :vh].transpose(1, 2)
    o = o * _head_mask(plan, cfg.n_heads, x.device, head0, hq)[
        None, None, :, None].to(o.dtype)
    return dense(p["wo"], o.reshape(b, s, -1)), cache


def mla_absorbed_parts(p, cfg: ModelConfig, plan: ShardPlan, x: torch.Tensor,
                       positions: torch.Tensor):
    """Absorbed-form decode inputs: ``W_k`` folded into the query, so
    ``q_nope[h] . (c W_k[h]) = (q_nope[h] W_k[h]^T) . c``. Returns (q_comb
    [B,S,H,lat+rope], latent [B,S,lat], rope key [B,S,rope])."""
    q_nope, q_rope = _mla_query(p, cfg, plan, x, positions)
    w_k, _ = _w_ukv(p, cfg, q_nope.shape[2], q_nope.dtype)
    q_abs = torch.einsum("bshd,lhd->bshl", q_nope, w_k)      # [B,S,H,lat]
    c_lat, k_rope = _mla_latent(p, cfg, x, positions)
    return torch.cat([q_abs, q_rope], dim=-1), c_lat, k_rope


def mla_page_dims(cfg: ModelConfig) -> tuple:
    """(hkv, dk, dv) of MLA's latent pages: one KV head whose K row is
    ``latent (+) rope key`` and whose V row is the latent."""
    return 1, cfg.kv_lora_rank + cfg.qk_rope_dim, cfg.kv_lora_rank


def mla_page_rows(latent: torch.Tensor, rope: torch.Tensor) -> tuple:
    """(k_rows [..., 1, lat+rope], v_rows [..., 1, lat]) in
    :func:`mla_page_dims`'s layout from latent [..., lat] and rope key
    [..., rope]."""
    return torch.cat([latent, rope], dim=-1)[..., None, :], \
        latent[..., None, :]


def mla_absorbed_out(p, cfg: ModelConfig, ctx: torch.Tensor) -> torch.Tensor:
    """ctx [B,S,H,lat] (attention-weighted latents) -> [B,S,H,v_head]:
    ``out[h] = (sum_t p_t c_t) W_v[h]``."""
    _, w_v = _w_ukv(p, cfg, ctx.shape[2], ctx.dtype)
    return torch.einsum("bshl,lhv->bshv", ctx, w_v)


def mla_decode_paged(p, cfg: ModelConfig, plan: ShardPlan, x: torch.Tensor,
                     k_pages: torch.Tensor, v_pages: torch.Tensor,
                     tables: torch.Tensor, lengths: torch.Tensor,
                     starts: torch.Tensor, positions: torch.Tensor,
                     write: tuple, impl: str = "kernel", head0: int = 0):
    """One-token MLA decode over latent pages (the reference engine's
    ``_mla_paged``), with :func:`gqa_decode_paged`'s arguments.

    ``k_pages`` [n_pages, page, 1, lat+rope] and ``v_pages`` [n_pages,
    page, 1, lat] (updated in place: the new token's ``latent (+) rope``
    and ``latent`` go into their slot). The absorbed query's ``Hq`` heads
    attend to the one latent "KV head" with ``scale = qk_head_dim **
    -0.5`` (not the operands' ``(lat+rope) ** -0.5``), then
    :func:`mla_absorbed_out`, the head mask and ``wo``. A model shard
    passes its weight slices (its heads), its own copy of the latent
    pools and ``head0``."""
    check_impl(impl)
    b = x.shape[0]
    q_comb, c_lat, k_rope = mla_absorbed_parts(p, cfg, plan, x,
                                               positions[:, None])
    rows, pages, slots = write
    k_rows, v_rows = mla_page_rows(c_lat, k_rope)            # [B,1,1,..]
    k_pages[pages, slots] = k_rows[rows, 0].to(k_pages.dtype)
    v_pages[pages, slots] = v_rows[rows, 0].to(v_pages.dtype)
    attend = paged_ops.paged_attention if impl == "kernel" \
        else paged_attention_ref
    ctx = attend(q_comb[:, 0].contiguous(), k_pages, v_pages, tables,
                 lengths + 1, starts, scale=cfg.qk_head_dim ** -0.5)
    o = mla_absorbed_out(p, cfg, ctx[:, None])               # [B,1,H,vh]
    o = o * _head_mask(plan, cfg.n_heads, x.device, head0, o.shape[2])[
        None, None, :, None].to(o.dtype)
    return dense(p["wo"], o.reshape(b, 1, -1)), k_pages, v_pages


# ---------------------------------------------------------------------------
# dense-cache decode: one page a sequence
# ---------------------------------------------------------------------------

def dense_window(batch: int, pos: int, device) -> tuple:
    """The paged decode's arguments that make a dense cache
    ``[B, Smax, Hkv, d]`` its page pool at absolute position ``pos``:
    ``(tables [B, 1] = [[0], ..., [B-1]], lengths [B] = pos, starts [B] =
    0, positions [B] = pos, write)``, ``write`` putting row b's new token
    into page b, slot ``pos`` (:func:`paged_write_rows`'s form). The
    decode functions attend over ``starts <= slot < lengths + 1``. Same for
    every layer: compute it once per decode step."""
    rows = torch.arange(batch, device=device)
    full = torch.full((batch,), pos, dtype=torch.int32, device=device)
    return (rows.to(torch.int32)[:, None], full, torch.zeros_like(full),
            full, (rows, rows, full.long()))


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder)
# ---------------------------------------------------------------------------

def cross_kv(p, cfg: ModelConfig, plan: ShardPlan, enc_out: torch.Tensor):
    """The encoder side's K, V once per sequence: enc_out [B,T,d] -> k, v
    [B,T,Hkv,dh], no RoPE and no qk-norm."""
    b, t, _ = enc_out.shape
    dh = cfg.head_dim
    return (dense(p["wk"], enc_out).reshape(b, t, -1, dh),
            dense(p["wv"], enc_out).reshape(b, t, -1, dh))


def _cross_out(p, cfg: ModelConfig, plan: ShardPlan, o: torch.Tensor,
               head0: int = 0) -> torch.Tensor:
    """[B,S,Hq,dh] attention output -> head mask, ``wo`` -> [B,S,d]."""
    b, s, hq = o.shape[:3]
    o = o * _head_mask(plan, cfg.n_heads, o.device, head0, hq)[
        None, None, :, None].to(o.dtype)
    return dense(p["wo"], o.reshape(b, s, -1))


def cross_full(p, cfg: ModelConfig, plan: ShardPlan, x: torch.Tensor,
               enc_kv: tuple, impl: str = "kernel", head0: int = 0
               ) -> torch.Tensor:
    """Decoder queries x [B,S,d] over the encoder's precomputed (k, v)
    [B,T,Hkv,dh] (:func:`cross_kv`), non-causal, scale ``dh ** -0.5``, no
    RoPE. The reference computes it with its XLA ``_sdpa`` whatever its
    ``impl``; here ``"kernel"`` runs the flash kernel (TPU kernel 6) with
    ``Sq = S``, ``Sk = T``, and ``"ref"`` ``mha_ref``. A model shard
    passes its weight slices, the K, V it computed (:func:`cross_kv` with
    its blocks) and ``head0``, as to :func:`gqa_full`."""
    check_impl(impl)
    b, s, _ = x.shape
    q = dense(p["wq"], x).reshape(b, s, -1, cfg.head_dim)
    ka, va = shard_kv(*enc_kv, plan, head0, q.shape[2])
    k, v = (a.to(q.dtype).transpose(1, 2).contiguous() for a in (ka, va))
    attend = flash_ops.flash_attention if impl == "kernel" else mha_ref
    o = attend(q.transpose(1, 2).contiguous(), k, v, causal=False)
    return _cross_out(p, cfg, plan, o.transpose(1, 2), head0)


def cross_decode(p, cfg: ModelConfig, plan: ShardPlan, x: torch.Tensor,
                 cross_k: torch.Tensor, cross_v: torch.Tensor,
                 impl: str = "kernel", head0: int = 0) -> torch.Tensor:
    """:func:`cross_full` for one decoder token x [B,1,d] over the read-only
    cross cache [B,T,Hkv,dh]: the paged kernel (TPU kernel 5) reads it as
    one page of T slots a sequence, the window ``0 <= slot < T``. A model
    shard whose KV heads shard passes its weight slices, its block of the
    cross cache and ``head0``."""
    check_impl(impl)
    b, t = cross_k.shape[:2]
    q = dense(p["wq"], x).reshape(b, -1, cfg.head_dim)
    tables, _, starts, _, _ = dense_window(b, 0, x.device)
    lengths = torch.full_like(starts, t)
    attend = paged_ops.paged_attention if impl == "kernel" \
        else paged_attention_ref
    o = attend(q, cross_k.to(q.dtype), cross_v.to(q.dtype), tables, lengths,
               starts)
    return _cross_out(p, cfg, plan, o[:, None], head0)


# ---------------------------------------------------------------------------
# decode on a model mesh where KV heads do not shard (models/parallel.py)
# ---------------------------------------------------------------------------

def _scores(q5: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``q5 [B,1,Hkv,g,w]``, ``k [B,T,Hkv,w]`` -> float32 ``[B,Hkv,g,1,T]``:
    the reference's ``einsum(..., preferred_element_type=float32)``
    (products of bf16 operands are exact in float32)."""
    return torch.einsum("bskgd,btkd->bkgst", q5.float(), k.float())


def _weighted(pr: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``pr [B,Hkv,g,1,T]`` cast to V's dtype, ``v [B,T,Hkv,w]`` -> float32
    ``[B,1,Hkv,g,w]``."""
    return torch.einsum("bkgst,btkd->bskgd", pr.to(v.dtype).float(),
                        v.float())


def _shard_out(ps: list, cfg: ModelConfig, plan: ShardPlan, lay, o: list
               ) -> list:
    """Every q head's output ``[B,1,Hq,dv]`` on each shard -> its heads,
    the head mask, its rows of ``wo``; summed over ``model``."""
    from repro_torch.launch import mesh as mesh_mod
    hq = plan.n_heads_padded // plan.model_size
    outs = []
    for s, (p, os_) in enumerate(zip(ps, o)):
        h0 = lay.j(s) * hq
        loc = os_[:, :, h0:h0 + hq]
        loc = loc * _head_mask(plan, cfg.n_heads, loc.device, h0, hq)[
            None, None, :, None].to(loc.dtype)
        outs.append(dense(p["wo"], loc.reshape(loc.shape[0], 1, -1)))
    return mesh_mod.collective("all_reduce", outs, lay.mesh, "model")


def decode_attn_kv_dh(ps: list, cfg: ModelConfig, plan: ShardPlan, lay,
                      hs: list, kcs: list, vcs: list, pos: int) -> list:
    """One decode step of a GQA layer whose cache shards on ``head_dim``
    (the ``kv_dh`` rule; KV heads replicated). Each shard writes its
    columns of the new token's K, V (every KV head: ``wk``/``wv`` are
    replicated) into slot ``pos`` of ``kcs[s]``/``vcs[s]`` ``[B, Smax,
    Hkv, dh/m]``; takes every q head (an ``all_gather`` of the shards'
    heads) at its columns and sums the partial ``q . k`` over the model
    axis; then the softmax over slots ``0 .. pos`` and ``P V`` on its
    columns, gathered back over ``head_dim``; then its heads through
    ``wo`` (:func:`_shard_out`). Plain torch, as the reference's XLA
    path. Returns the layer's output, replicated over ``model``."""
    from repro_torch.launch import mesh as mesh_mod
    mesh = lay.mesh
    hkv, g = plan.n_kv_heads_padded, plan.group_size
    qs, t = [], pos + 1
    for s, (p, h) in enumerate(zip(ps, hs)):
        positions = torch.full((1,), pos, dtype=torch.int32, device=h.device)
        q, k_new, v_new = _gqa_qkv(p, cfg, plan, h, positions)
        w = kcs[s].shape[-1]
        c0 = lay.j(s) * w
        kcs[s][:, pos] = k_new[:, 0, :, c0:c0 + w].to(kcs[s].dtype)
        vcs[s][:, pos] = v_new[:, 0, :, c0:c0 + w].to(vcs[s].dtype)
        qs.append(q)
    qs = mesh_mod.collective("all_gather", qs, mesh, "model", dim=2)
    sc = []
    for s, q in enumerate(qs):
        w = kcs[s].shape[-1]
        c0 = lay.j(s) * w
        q5 = q[..., c0:c0 + w].reshape(q.shape[0], 1, hkv, g, w)
        sc.append(_scores(q5, kcs[s][:, :t].to(q.dtype)))
    sc = mesh_mod.collective("all_reduce", sc, mesh, "model")
    os_ = []
    for s, (q, a) in enumerate(zip(qs, sc)):
        a = a * cfg.head_dim ** -0.5
        pr = torch.exp(a - a.amax(-1, keepdim=True))
        pr = pr / pr.sum(-1, keepdim=True).clamp(min=1e-30)
        os_.append(_weighted(pr, vcs[s][:, :t].to(q.dtype)))
    os_ = mesh_mod.collective("all_gather", os_, mesh, "model", dim=-1)
    o = [x.reshape(x.shape[0], 1, plan.n_heads_padded, -1).to(q.dtype)
         for x, q in zip(os_, qs)]
    return _shard_out(ps, cfg, plan, lay, o)


def _seqshard_axes(plan: ShardPlan):
    """Mesh axes the decode cache's sequence dim shards over (or None):
    only rules set by hand map ``kv_seq`` to ``model``."""
    rules = plan.rules_dict
    if not rules:
        return None
    r = rules.get("kv_seq")
    if r is None:
        return None
    axes = r if isinstance(r, tuple) else (r,)
    return axes if "model" in axes else None


def decode_attn_seqshard(ps: list, cfg: ModelConfig, plan: ShardPlan, lay,
                         hs: list, kcs: list, vcs: list, pos: int,
                         seq_axes: tuple) -> list:
    """One decode step of a GQA layer whose cache shards on its sequence
    (the reference's ``_decode_attn_seqshard`` and the sequence-sharded
    branch of ``decode_attn_stacked``). ``kcs[s]``/``vcs[s]`` ``[B,
    Smax/n, Hkv, dh]`` hold slots ``idx * Smax/n ..`` (``idx`` the shard's
    position along ``seq_axes``). Only the shard that owns slot ``pos``
    writes the new token; every shard attends with every q head over its
    own slots (those ``<= pos``); the partials merge by log-sum-exp: the
    maximum over the shards (``max``), then the sums of the weights and
    of the weighted values (``all_reduce``). Returns the layer's output,
    replicated over ``model``."""
    from repro_torch.launch import mesh as mesh_mod
    mesh = lay.mesh
    hkv, g = plan.n_kv_heads_padded, plan.group_size
    qs = []
    for s, (p, h) in enumerate(zip(ps, hs)):
        positions = torch.full((1,), pos, dtype=torch.int32, device=h.device)
        q, k_new, v_new = _gqa_qkv(p, cfg, plan, h, positions)
        s_loc = kcs[s].shape[1]
        idx = mesh.position(s, seq_axes)
        if idx * s_loc <= pos < (idx + 1) * s_loc:
            kcs[s][:, pos - idx * s_loc] = k_new[:, 0].to(kcs[s].dtype)
            vcs[s][:, pos - idx * s_loc] = v_new[:, 0].to(vcs[s].dtype)
        qs.append(q)
    qs = mesh_mod.collective("all_gather", qs, mesh, "model", dim=2)
    sc, mx = [], []
    for s, q in enumerate(qs):
        s_loc = kcs[s].shape[1]
        q5 = q.reshape(q.shape[0], 1, hkv, g, -1)
        a = _scores(q5, kcs[s].to(q.dtype)) * cfg.head_dim ** -0.5
        slot = mesh.position(s, seq_axes) * s_loc + torch.arange(
            s_loc, device=q.device)
        a = a.masked_fill(slot > pos, float("-inf"))
        sc.append(a)
        mx.append(a.amax(-1, keepdim=True))
    mx = mesh_mod.collective("max", mx, mesh, seq_axes)
    prs, ls = [], []
    for a, m_g in zip(sc, mx):
        pr = torch.exp(a - torch.where(torch.isfinite(m_g), m_g,
                                       torch.zeros_like(m_g)))
        prs.append(pr)
        ls.append(pr.sum(-1, keepdim=True))
    ls = mesh_mod.collective("all_reduce", ls, mesh, seq_axes)
    os_ = mesh_mod.collective("all_reduce", [
        _weighted(pr, vcs[s].to(q.dtype))
        for s, (pr, q) in enumerate(zip(prs, qs))], mesh, seq_axes)
    o = [(x / lg.permute(0, 3, 1, 2, 4).clamp(min=1e-30)).reshape(
        x.shape[0], 1, plan.n_heads_padded, -1).to(q.dtype)
        for x, lg, q in zip(os_, ls, qs)]
    return _shard_out(ps, cfg, plan, lay, o)
