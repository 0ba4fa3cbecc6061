"""Model assembly for decoder-only LMs: dense GQA or MLA attention (with
MoE, shared experts included, and an image-patch prefix), RWKV6, and the
hybrid Mamba + attention + MoE stack.

Counterpart of ``repro/models/model.py``: ``init_params``,
``forward(..., collect_cache=True)`` (the prefill of the paged engine) and
``apply_layer``, the layer body that prefill and the engine's decode
share.
The parameters are a :class:`DecoderLM` module: ``embed``, ``final_norm``
(and ``head`` unless embeddings are tied) as parameter groups, and an
``nn.ModuleList`` of layers, each an ``nn.ModuleDict`` named as in the
reference's param tree (``_init_layer``): ``ln1``; the mixer, ``attn``
(GQA, or MLA where ``cfg.attention == "mla"``), ``tm`` (RWKV6 time-mix)
or ``mamba``; ``ln2``; the feed-forward, ``mlp``, ``cm`` (RWKV6
channel-mix) or ``moe`` (with its nested ``shared`` group where the
config has shared experts). Layer ``l`` is the
reference's period position ``l % period``, entry ``l // period`` of its
stack, and its kinds come from ``cfg.is_attn_layer`` / ``cfg.block`` /
``cfg.is_moe_layer`` at that position. A Python loop over the layers, in
order, takes the place of the reference's ``lax.scan`` over the period
stack.

Storage dtype: every use of a weight casts it to the activation dtype
(``common.dense``), as the reference does. So ``init_params`` stores the
matrices and embeddings in ``cfg.dtype`` (bf16 at full width) and the
leaves the reference uses in float32 (norm scales, RWKV's decay base,
bonus and group-norm, Mamba's ``a_log``, ``dt_bias`` and ``d``) in
float32, with the numbers a float32 store would give after the cast.

The encoder-decoder (Whisper) is not ported: it raises
``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.common import (
    apply_norm,
    embed_init,
    embed_lookup,
    lm_head,
    norm_init,
    param_group,
)
from repro_torch.sharding.rules import ShardPlan
from repro_torch.utils import resolve_device

ROADMAP = {
    "enc_dec": "ROADMAP.md queue 1 item 13d (whisper encoder-decoder)",
}
# the mixer kinds, in the order ``forward`` returns their caches
KINDS = ("attn", "rwkv", "mamba")
# parameter groups stored in float32 whatever cfg.dtype (see above)
FLOAT32_LEAVES = {"ln1": None, "ln2": None, "final_norm": None,
                  "attn": {"q_norm", "k_norm", "q_ln", "kv_ln"},
                  "tm": rwkv_mod.FLOAT32_LEAVES,
                  "mamba": mamba_mod.FLOAT32_LEAVES}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is a decoder-only LM
    whose blocks are ported: GQA or MLA attention, RWKV6, Mamba, dense
    MLPs, MoE (shared experts included), no frontend or the vision
    stub's prefix embeddings."""
    if cfg.enc_dec:
        raise NotImplementedError(
            f"{cfg.name}: enc_dec is not ported: {ROADMAP['enc_dec']}")
    if cfg.block not in ("attn", "rwkv", "hybrid") or \
            cfg.attention not in ("gqa", "mla", "none") or \
            cfg.frontend not in ("none", "vision_stub"):
        raise NotImplementedError(
            f"{cfg.name}: attention={cfg.attention!r} block={cfg.block!r} "
            f"frontend={cfg.frontend!r} is not ported")


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """The mixer of every layer, in order: ``"attn"``, ``"rwkv"`` or
    ``"mamba"``, as the reference's ``_init_layer`` picks it at period
    position ``layer % period``."""
    other = "rwkv" if cfg.block == "rwkv" else "mamba"
    return ["attn" if cfg.is_attn_layer(li % cfg.layer_period) else other
            for li in range(cfg.n_layers)]


def ordinals(cfg: ModelConfig) -> list[int]:
    """Each layer's index among the layers of its mixer kind: where its
    caches sit in the per-kind stacks."""
    seen = dict.fromkeys(KINDS, 0)
    out = []
    for kind in layer_kinds(cfg):
        out.append(seen[kind])
        seen[kind] += 1
    return out


def kinds_present(cfg: ModelConfig) -> list[str]:
    """The mixer kinds ``cfg`` has, in ``KINDS`` order."""
    have = set(layer_kinds(cfg))
    return [k for k in KINDS if k in have]


class DecoderLM(nn.Module):
    """Parameters of a decoder-only LM, named as the reference's tree."""

    def __init__(self, embed: dict, final_norm: dict, layers: list,
                 head: dict | None = None):
        super().__init__()
        self.embed = param_group(**embed)
        self.final_norm = param_group(**final_norm)
        if head is not None:
            self.head = param_group(**head)
        self.layers = nn.ModuleList(layers)

    @property
    def lm_head_params(self):
        return self.head if hasattr(self, "head") else self.embed

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device


def layer_module(**groups) -> nn.ModuleDict:
    """One layer from its parameter groups (dicts of tensors or
    ``nn.ParameterDict``), in the reference's order ``ln1``, mixer,
    ``ln2``, feed-forward."""
    return nn.ModuleDict({name: g if isinstance(g, nn.ParameterDict)
                          else param_group(**g)
                          for name, g in groups.items()})


def _init_layer(gen, cfg: ModelConfig, plan: ShardPlan, layer: int,
                kind: str, dev, dtype) -> nn.ModuleDict:
    """Layer ``layer``'s parameters (the reference's ``_init_layer``);
    ``kind`` is its mixer."""
    pos = layer % cfg.layer_period
    g = {"ln1": norm_init(cfg.d_model, cfg.norm, dev)}
    if kind == "attn":
        g["attn"] = (attn.init_mla if cfg.attention == "mla"
                     else attn.init_gqa)(gen, cfg, plan, dev, dtype)
    elif kind == "rwkv":
        g["tm"] = rwkv_mod.init_time_mix(gen, cfg, plan, dev, dtype)
    else:
        g["mamba"] = mamba_mod.init_mamba(gen, cfg, plan, dev, dtype)
    g["ln2"] = norm_init(cfg.d_model, cfg.norm, dev)
    if cfg.is_moe_layer(pos):
        g["moe"] = mlp_mod.init_moe(gen, cfg, plan, dev, dtype)
    elif cfg.block == "rwkv":
        g["cm"] = rwkv_mod.init_channel_mix(gen, cfg, dev, dtype)
    else:
        g["mlp"] = mlp_mod.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act,
                                    dev, dtype)
    return layer_module(**g)


def init_params(cfg: ModelConfig, plan: ShardPlan, seed: int = 0,
                device="cuda") -> DecoderLM:
    """Random parameters from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (default the card). Matrices and embeddings are stored in
    ``cfg.dtype``; the float32 leaves stay float32."""
    check_supported(cfg)
    if cfg.n_layers % cfg.layer_period:
        raise ValueError(f"{cfg.n_layers} layers is not a whole number of "
                         f"periods of {cfg.layer_period}")
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    embed = embed_init(gen, plan.vocab_padded, cfg.d_model, dev, dtype)
    layers = [_init_layer(gen, cfg, plan, li, kind, dev, dtype)
              for li, kind in enumerate(layer_kinds(cfg))]
    head = None if cfg.tie_embeddings else embed_init(
        gen, plan.vocab_padded, cfg.d_model, dev, dtype)
    return DecoderLM(embed, norm_init(cfg.d_model, cfg.norm, dev), layers,
                     head)


def forward(params: DecoderLM, cfg: ModelConfig, plan: ShardPlan,
            batch: dict, impl: str = "kernel", collect_cache: bool = False):
    """Full-sequence forward. batch: tokens [B,S], and for the vision stub
    (``cfg.frontend == "vision_stub"``) optionally ``prefix_embeds``
    [B,n_img,d], which replace the embeddings of the first ``n_img``
    positions (the reference's image-patch prefix).

    Returns (logits [B,S,V], aux_loss (the MoE layers' sum, float32),
    caches | None). The caches are one entry per mixer kind the model has
    (:func:`kinds_present`, in ``KINDS`` order), each a tuple stacked over
    the layers of that kind in layer order:

      * ``attn``: ``(k, v)``, each ``[n_attn, B, S, Hkv, dh]``; for MLA
        the absorbed form ``(latent [n_attn, B, S, kv_lora], rope key
        [n_attn, B, S, qk_rope])`` (:func:`models.attention.mla_full`);
      * ``rwkv``: ``(x_prev of time-mix [n, B, 1, d], S [n, B, H, hs, hs]
        float32, x_prev of channel-mix [n, B, 1, d])``;
      * ``mamba``: ``(conv state [n, B, K-1, di], h [n, B, di, n_state]
        float32)``.

    For a dense GQA model that is ``[(k, v)]``, as before. ``impl`` as in
    ``models.attention`` (``"kernel"``: the hand-written kernels on the
    card; ``"ref"``: the plain versions)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    dtype = getattr(torch, cfg.dtype)
    x = embed_lookup(params.embed, tokens, dtype)
    if cfg.frontend == "vision_stub" and "prefix_embeds" in batch:
        pre = batch["prefix_embeds"].to(dtype)
        x = torch.cat([pre, x[:, pre.shape[1]:]], dim=1)
    positions = torch.arange(s, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = {k: [] for k in KINDS}

    full = attn.mla_full if cfg.attention == "mla" else attn.gqa_full

    def attend(p, h):
        return full(p, cfg, plan, h, positions, causal=True, impl=impl)

    for li, (lp, kind) in enumerate(zip(params.layers, layer_kinds(cfg))):
        x, a, c = apply_layer(lp, cfg, plan, li, kind, x, attend, impl=impl)
        if a is not None:
            aux = aux + a
        if collect_cache:
            caches[kind].append(c)
    x = apply_norm(params.final_norm, x)
    logits = lm_head(params.lm_head_params, x, cfg.vocab_size)
    if not collect_cache:
        return logits, aux, None
    return logits, aux, [tuple(torch.stack(parts) for parts in
                               zip(*caches[k])) for k in kinds_present(cfg)]


def apply_layer(lp, cfg: ModelConfig, plan: ShardPlan, li: int, kind: str,
                x: torch.Tensor, attend, state=None, impl: str = "kernel"):
    """Layer ``li`` (mixer ``kind``) on x [B,T,d], for prefill and decode
    alike (the reference's ``_apply_layer_full`` and the layer body of its
    engine's ``_decode``). ``attend(p, h)`` runs the layer's attention
    mixer and returns ``(out, cache)``: the one step in which prefill and
    decode differ. ``state`` is the layer's recurrent
    state as ``forward`` returns it among its caches (``None``: the zero
    state). Returns ``(x, aux, cache)``: aux is the MoE loss (``None``
    without MoE), cache the attention mixer's or the new recurrent
    state."""
    b = x.shape[0]
    h = apply_norm(lp["ln1"], x)
    if kind == "attn":
        o, c = attend(lp["attn"], h)
    elif kind == "rwkv":
        st = state[:2] if state is not None else \
            rwkv_mod.init_time_mix_state(cfg, plan, b, x.dtype, x.device)
        o, c = rwkv_mod.time_mix(lp["tm"], cfg, plan, h, st, impl=impl)
    else:
        st = state if state is not None else \
            mamba_mod.init_mamba_state(cfg, b, x.dtype, x.device)
        o, c = mamba_mod.mamba_block(lp["mamba"], cfg, plan, h, st,
                                     impl=impl)
    x = x + o
    h = apply_norm(lp["ln2"], x)
    aux = None
    if cfg.is_moe_layer(li % cfg.layer_period):
        o, aux = mlp_mod.moe(lp["moe"], cfg, plan, h)
    elif cfg.block == "rwkv":
        xc = state[2] if state is not None else torch.zeros_like(x[:, :1])
        o, xc = rwkv_mod.channel_mix(lp["cm"], cfg, h, xc)
        c = c + (xc,)
    else:
        o = mlp_mod.apply_mlp(lp["mlp"], h, cfg.mlp_act)
    return x + o, aux, c
