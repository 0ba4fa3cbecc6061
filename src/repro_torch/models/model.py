"""Model assembly for decoder-only attention LMs (dense GQA).

Counterpart of ``repro/models/model.py``: ``init_params`` and
``forward(..., collect_cache=True)``, the prefill of the paged engine.
The parameters are a :class:`DecoderLM` module: ``embed``, ``final_norm``
(and ``head`` unless embeddings are tied) as parameter groups, and an
``nn.ModuleList`` of layers, each an ``nn.ModuleDict`` of ``ln1``,
``attn``, ``ln2``, ``mlp`` named as in the reference's param tree. Layer
``l`` is the reference's period position ``l % period``, entry
``l // period`` of its stack. A Python loop over the layers takes the
place of the reference's ``lax.scan`` over the period stack.

Storage dtype: every use of a weight casts it to the activation dtype
(``common.dense``), as the reference does. So ``init_params`` stores the
matrices and embeddings in ``cfg.dtype`` (bf16 at full width: 16.06 GB
for Llama-3-8B rather than 32 GB in float32) and the norm scales in
float32, with the numbers a float32 store would give after the cast.

Architectures whose blocks are not ported (rwkv, hybrid, MLA, MoE,
encoder-decoder, the vision stub) raise ``NotImplementedError`` naming
their ROADMAP item.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
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
    "rwkv": "ROADMAP.md queue 2 item 8 (wkv6, models/rwkv.py)",
    "hybrid": "ROADMAP.md queue 2 item 7 (mamba_scan, models/mamba.py)",
    "mla": "ROADMAP.md queue 1 item 13 (models/attention.py MLA)",
    "moe": mlp_mod.ROADMAP_MOE,
    "enc_dec": "ROADMAP.md queue 1 item 13 (whisper encoder-decoder)",
    "vision_stub": "ROADMAP.md queue 1 item 13 (VLM prefix embeddings)",
}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is a decoder-only
    attention LM with dense GQA blocks."""
    for what, unported in (("rwkv", cfg.block == "rwkv"),
                           ("hybrid", cfg.block == "hybrid"),
                           ("mla", cfg.attention == "mla"),
                           ("moe", cfg.moe),
                           ("enc_dec", cfg.enc_dec),
                           ("vision_stub", cfg.frontend == "vision_stub")):
        if unported:
            raise NotImplementedError(
                f"{cfg.name}: {what} is not ported: {ROADMAP[what]}")
    if cfg.attention != "gqa" or cfg.block != "attn":
        raise NotImplementedError(
            f"{cfg.name}: attention={cfg.attention!r} block={cfg.block!r} is "
            f"not ported: {ROADMAP['mla']}")


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


def layer_module(ln1: dict, attn_p, ln2: dict, mlp_p) -> nn.ModuleDict:
    return nn.ModuleDict({"ln1": param_group(**ln1), "attn": attn_p,
                          "ln2": param_group(**ln2), "mlp": mlp_p})


def init_params(cfg: ModelConfig, plan: ShardPlan, seed: int = 0,
                device="cuda") -> DecoderLM:
    """Random parameters from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (default the card). Matrices and embeddings are stored in
    ``cfg.dtype``; norm scales stay float32."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    embed = embed_init(gen, plan.vocab_padded, cfg.d_model, dev, dtype)
    layers = [layer_module(
        norm_init(cfg.d_model, cfg.norm, dev),
        attn.init_gqa(gen, cfg, plan, dev, dtype),
        norm_init(cfg.d_model, cfg.norm, dev),
        mlp_mod.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act, dev, dtype))
        for _ in range(cfg.n_layers)]
    head = None if cfg.tie_embeddings else embed_init(
        gen, plan.vocab_padded, cfg.d_model, dev, dtype)
    return DecoderLM(embed, norm_init(cfg.d_model, cfg.norm, dev), layers,
                     head)


def forward(params: DecoderLM, cfg: ModelConfig, plan: ShardPlan,
            batch: dict, impl: str = "kernel", collect_cache: bool = False):
    """Full-sequence forward. batch: tokens [B,S].

    Returns (logits [B,S,V], aux_loss (0.0), caches | None). The caches
    mirror the reference's for a period of 1: one ``(k, v)`` pair, each
    stacked over the layers, ``[n_layers, B, S, Hkv, dh]``. ``impl`` as in
    ``models.attention`` (``"kernel"``: kernel 6 on the card)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    dtype = getattr(torch, cfg.dtype)
    x = embed_lookup(params.embed, tokens, dtype)
    positions = torch.arange(s, device=x.device)
    ks, vs = [], []
    for lp in params.layers:
        h = apply_norm(lp["ln1"], x)
        o, (k, v) = attn.gqa_full(lp["attn"], cfg, plan, h, positions,
                                  causal=True, impl=impl)
        x = x + o
        if collect_cache:
            ks.append(k)
            vs.append(v)
        h = apply_norm(lp["ln2"], x)
        x = x + mlp_mod.apply_mlp(lp["mlp"], h, cfg.mlp_act)
    x = apply_norm(params.final_norm, x)
    logits = lm_head(params.lm_head_params, x, cfg.vocab_size)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = [(torch.stack(ks), torch.stack(vs))] if collect_cache else None
    return logits, aux, caches
