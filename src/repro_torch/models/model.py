"""Model assembly: decoder LMs (dense GQA or MLA attention, with MoE,
shared experts included, and an image-patch prefix; RWKV6; the hybrid
Mamba + attention + MoE stack) and the Whisper encoder-decoder.

Counterpart of ``repro/models/model.py``: ``init_params``,
``forward(..., collect_cache=True)`` (the prefill of the paged engine),
``encode`` (the reference's ``_encode``), the dense-cache
``init_decode_cache`` / ``decode_step``, ``lm_loss``, and
``apply_layer``, the one layer body that prefill, the paged engine's
decode and the dense decode share (Whisper's decoder layer included: its
cross-attention sits between the self-attention and the MLP).
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
stack. Whisper's decoder layers add ``ln_x`` and ``xattn`` (the
cross-attention's GQA group) after ``attn``; its module also holds
``encoder`` (``layers``, each ``ln1, attn, ln2, mlp``, and the group
``ln_post``) and ``dec_pos`` (the learned decoder positions ``table``).

Storage dtype: every use of a weight casts it to the activation dtype
(``common.dense``), as the reference does. So ``init_params`` stores the
matrices and embeddings in ``cfg.dtype`` (bf16 at full width) unless the
caller names another storage dtype (the trainer's float32 master
weights), and the leaves the reference uses in float32 (norm scales,
RWKV's decay base, bonus and group-norm, Mamba's ``a_log``, ``dt_bias``
and ``d``) in float32, with the numbers a float32 store would give after
the cast.

The dense decode cache (:func:`init_decode_cache`) is a dict by mixer
kind, each entry a tuple of stacks over that kind's layers in layer
order, as ``forward``'s caches and the paged engine's pools are:

  * ``attn``: ``(k, v)`` ``[n_attn, B, Smax, Hkv, dh]``; MLA in its
    latent pages' layout, K ``[.., Smax, 1, kv_lora + qk_rope]`` (latent
    (+) rope key) and V ``[.., Smax, 1, kv_lora]`` (1,088 bytes a token
    and layer in bf16 at MiniCPM3's widths, where the reference's two
    arrays hold 576: the paged kernel reads K and V as two pools);
    Whisper adds the read-only cross caches ``(xk, xv)`` ``[n, B,
    enc_seq, Hkv, dh]``, filled by :func:`fill_cross_cache`;
  * ``rwkv``: ``(x_prev [n, B, 1, d], S float32 [n, B, H, hs, hs],
    channel-mix x_prev [n, B, 1, d])``;
  * ``mamba``: ``(conv state [n, B, K-1, di], h float32 [n, B, di, N])``.

``interop.decode_cache_to_numpy`` crosses it to the reference's list per
period position.

``forward``, ``encode``, ``init_decode_cache``, ``fill_cross_cache`` and
``decode_step`` take ``mesh=`` (a ``launch.mesh.ModelMesh``) with a plan
made for it: every architecture then runs tensor-parallel on the mesh's
shards (``models.parallel``), and its caches are per shard.
"""
from __future__ import annotations

import functools

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
    normal,
    param_group,
    sinusoid_positions,
)
from repro_torch.sharding.rules import ShardPlan
from repro_torch.utils import resolve_device

# the mixer kinds, in the order ``forward`` returns their caches
KINDS = ("attn", "rwkv", "mamba")
# parameter groups stored in float32 whatever cfg.dtype (see above)
FLOAT32_LEAVES = {"ln1": None, "ln2": None, "ln_x": None, "final_norm": None,
                  "ln_post": None,
                  "attn": {"q_norm", "k_norm", "q_ln", "kv_ln"},
                  "xattn": {"q_norm", "k_norm"},
                  "tm": rwkv_mod.FLOAT32_LEAVES,
                  "mamba": mamba_mod.FLOAT32_LEAVES}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless ``cfg``'s blocks are ported: a
    decoder-only LM (GQA or MLA attention, RWKV6, Mamba, dense MLPs, MoE
    with shared experts included; no frontend or the vision stub's
    prefix embeddings), or the GQA encoder-decoder over the audio stub's
    frames."""
    if cfg.enc_dec:
        ok = cfg.block == "attn" and cfg.attention == "gqa" and \
            cfg.frontend == "audio_stub" and not cfg.moe
    else:
        ok = cfg.block in ("attn", "rwkv", "hybrid") and \
            cfg.attention in ("gqa", "mla", "none") and \
            cfg.frontend in ("none", "vision_stub")
    if not ok:
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
    """Parameters of an LM, named as the reference's tree; an
    encoder-decoder also has ``encoder`` (``layers``, ``ln_post``) and
    ``dec_pos``."""

    def __init__(self, embed: dict, final_norm: dict, layers: list,
                 head: dict | None = None, encoder: dict | None = None,
                 dec_pos: dict | None = None):
        super().__init__()
        self.embed = param_group(**embed)
        self.final_norm = param_group(**final_norm)
        if head is not None:
            self.head = param_group(**head)
        self.layers = nn.ModuleList(layers)
        if encoder is not None:
            self.encoder = nn.ModuleDict({
                "layers": nn.ModuleList(encoder["layers"]),
                "ln_post": param_group(**encoder["ln_post"])})
            self.dec_pos = param_group(**dec_pos)

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
    """Layer ``layer``'s parameters (the reference's ``_init_layer``, and
    its ``_init_dec_layer`` for an encoder-decoder); ``kind`` is its
    mixer."""
    pos = layer % cfg.layer_period
    g = {"ln1": norm_init(cfg.d_model, cfg.norm, dev)}
    if kind == "attn":
        g["attn"] = (attn.init_mla if cfg.attention == "mla"
                     else attn.init_gqa)(gen, cfg, plan, dev, dtype)
        if cfg.enc_dec:
            g["ln_x"] = norm_init(cfg.d_model, cfg.norm, dev)
            g["xattn"] = attn.init_gqa(gen, cfg, plan, dev, dtype)
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


def _init_enc_layer(gen, cfg: ModelConfig, plan: ShardPlan, dev, dtype
                    ) -> nn.ModuleDict:
    """An encoder layer (the reference's ``_init_enc_layer``)."""
    return layer_module(
        ln1=norm_init(cfg.d_model, cfg.norm, dev),
        attn=attn.init_gqa(gen, cfg, plan, dev, dtype),
        ln2=norm_init(cfg.d_model, cfg.norm, dev),
        mlp=mlp_mod.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act, dev,
                             dtype))


def init_params(cfg: ModelConfig, plan: ShardPlan, seed: int = 0,
                device="cuda", max_seq: int = 4096, dtype=None
                ) -> DecoderLM:
    """Random parameters from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (default the card). Matrices and embeddings are stored in
    ``dtype`` (default ``cfg.dtype``; the trainer's master weights pass
    ``torch.float32``); the float32 leaves stay float32. An
    encoder-decoder's learned decoder positions hold ``max_seq`` rows, as
    the reference's do."""
    check_supported(cfg)
    if cfg.n_layers % cfg.layer_period:
        raise ValueError(f"{cfg.n_layers} layers is not a whole number of "
                         f"periods of {cfg.layer_period}")
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype) if dtype is None else dtype
    # the meta device (shapes only) draws nothing: any generator will do
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(seed)
    embed = embed_init(gen, plan.vocab_padded, cfg.d_model, dev, dtype)
    layers = [_init_layer(gen, cfg, plan, li, kind, dev, dtype)
              for li, kind in enumerate(layer_kinds(cfg))]
    head = None if cfg.tie_embeddings else embed_init(
        gen, plan.vocab_padded, cfg.d_model, dev, dtype)
    encoder = dec_pos = None
    if cfg.enc_dec:
        encoder = {"layers": [_init_enc_layer(gen, cfg, plan, dev, dtype)
                              for _ in range(cfg.n_enc_layers)],
                   "ln_post": norm_init(cfg.d_model, cfg.norm, dev)}
        dec_pos = {"table": normal(gen, (max_seq, cfg.d_model), 0.01, dev,
                                   dtype)}
    return DecoderLM(embed, norm_init(cfg.d_model, cfg.norm, dev), layers,
                     head, encoder, dec_pos)


def encode(params: DecoderLM, cfg: ModelConfig, plan: ShardPlan,
           frames: torch.Tensor, impl: str = "kernel", mesh=None):
    """Whisper's encoder (the reference's ``_encode``) over the stub's
    frame embeddings [B, T, d]: sinusoid positions added, then each layer
    (``ln1``, non-causal ``gqa_full`` with RoPE as the reference applies
    it, ``ln2``, MLP), then ``ln_post``. Returns [B, T, d] in
    ``cfg.dtype``; with ``mesh``, each shard's ``[B_l, T, d]``
    (``models.parallel.encode``)."""
    if mesh is not None:
        from repro_torch.models import parallel
        return parallel.encode(params, cfg, plan, frames, mesh, impl)
    dtype = getattr(torch, cfg.dtype)
    _, t, _ = frames.shape
    x = frames.to(dtype) + sinusoid_positions(
        t, cfg.d_model, frames.device).to(dtype)[None]
    positions = torch.arange(t, device=x.device)

    def attend(p, h):
        return attn.gqa_full(p, cfg, plan, h, positions, causal=False,
                             impl=impl)

    for lp in params.encoder["layers"]:
        x, _, _ = apply_layer(lp, cfg, plan, 0, "attn", x, attend, impl=impl)
    return apply_norm(params.encoder["ln_post"], x)


def forward(params: DecoderLM, cfg: ModelConfig, plan: ShardPlan,
            batch: dict, impl: str = "kernel", collect_cache: bool = False,
            mesh=None):
    """Full-sequence forward. batch: tokens [B,S]; for the vision stub
    (``cfg.frontend == "vision_stub"``) optionally ``prefix_embeds``
    [B,n_img,d], which replace the embeddings of the first ``n_img``
    positions (the reference's image-patch prefix); for the
    encoder-decoder ``enc_frames`` [B,T,d], which :func:`encode` turns
    into the cross-attention's keys and values, and the learned
    ``dec_pos`` rows ``0..S-1`` are added to the token embeddings.

    Returns (logits [B,S,V], aux_loss (the MoE layers' sum, float32),
    caches | None). The caches are one entry per mixer kind the model has
    (:func:`kinds_present`, in ``KINDS`` order), each a tuple stacked over
    the layers of that kind in layer order:

      * ``attn``: ``(k, v)``, each ``[n_attn, B, S, Hkv, dh]`` (Whisper's
        self-attention only, as the reference's); for MLA the absorbed
        form ``(latent [n_attn, B, S, kv_lora], rope key [n_attn, B, S,
        qk_rope])`` (:func:`models.attention.mla_full`);
      * ``rwkv``: ``(x_prev of time-mix [n, B, 1, d], S [n, B, H, hs, hs]
        float32, x_prev of channel-mix [n, B, 1, d])``;
      * ``mamba``: ``(conv state [n, B, K-1, di], h [n, B, di, n_state]
        float32)``.

    For a dense GQA model that is ``[(k, v)]``, as before. ``impl`` as in
    ``models.attention`` (``"kernel"``: the hand-written kernels on the
    card; ``"ref"``: the plain versions).

    With ``mesh`` (a ``launch.mesh.ModelMesh``) and the plan made for it,
    the model runs tensor-parallel on the mesh's shards
    (``models.parallel.forward``; its caches are per shard)."""
    check_supported(cfg)
    if mesh is not None:
        from repro_torch.models import parallel
        return parallel.forward(params, cfg, plan, batch, mesh, impl,
                                collect_cache)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    dtype = getattr(torch, cfg.dtype)
    x = embed_lookup(params.embed, tokens, dtype)
    if cfg.frontend == "vision_stub" and "prefix_embeds" in batch:
        pre = batch["prefix_embeds"].to(dtype)
        x = torch.cat([pre, x[:, pre.shape[1]:]], dim=1)
    cross = None
    if cfg.enc_dec:
        enc_out = encode(params, cfg, plan, batch["enc_frames"], impl)
        x = x + params.dec_pos["table"][:s].to(dtype)[None]

        def cross(p, h):
            return attn.cross_full(p, cfg, plan, h,
                                   attn.cross_kv(p, cfg, plan, enc_out),
                                   impl=impl)
    positions = torch.arange(s, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = {k: [] for k in KINDS}

    full = attn.mla_full if cfg.attention == "mla" else attn.gqa_full

    def attend(p, h):
        return full(p, cfg, plan, h, positions, causal=True, impl=impl)

    for li, (lp, kind) in enumerate(zip(params.layers, layer_kinds(cfg))):
        x, a, c = apply_layer(lp, cfg, plan, li, kind, x, attend, impl=impl,
                              cross=cross)
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
                x: torch.Tensor, attend, state=None, impl: str = "kernel",
                cross=None):
    """Layer ``li`` (mixer ``kind``) on x [B,T,d], for prefill and decode
    alike (the reference's ``_apply_layer_full``, its
    ``_apply_dec_layer_full`` and the layer bodies of its engine's
    ``_decode`` and of its ``decode_step``). ``attend(p, h)`` runs the
    layer's attention mixer and returns ``(out, cache)``: the one step in
    which prefill and decode differ. A layer with a cross-attention group
    (``xattn``) then adds ``cross(p, ln_x(x))``, the attention over the
    encoder's keys and values. ``state`` is the layer's recurrent
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
    if "xattn" in lp:
        x = x + cross(lp["xattn"], apply_norm(lp["ln_x"], x))
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


# ---------------------------------------------------------------------------
# dense-cache decode (one token, caches updated in place)
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ModelConfig, plan: ShardPlan, batch: int,
                      max_seq: int, dtype=None, device="cuda", mesh=None):
    """Zero caches for :func:`decode_step` of ``batch`` sequences of up to
    ``max_seq`` positions on ``device`` (default the card), in the layout
    the module docstring gives; ``dtype`` (default ``cfg.dtype``) for all
    but RWKV's ``S`` and Mamba's ``h``, which are float32 as the
    reference's. With ``mesh``, each shard's block of the attention
    caches on the shard's device (``models.parallel.init_decode_cache``),
    and ``device`` is not read."""
    check_supported(cfg)
    if mesh is not None:
        from repro_torch.models import parallel
        return parallel.init_decode_cache(cfg, plan, batch, max_seq, mesh,
                                          dtype)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype) if dtype is None else dtype
    n = {k: layer_kinds(cfg).count(k) for k in KINDS}
    caches = {}

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)
    if n["attn"]:
        hkv, dk, dv = plan.n_kv_heads_padded, cfg.head_dim, cfg.head_dim
        if cfg.attention == "mla":
            hkv, dk, dv = attn.mla_page_dims(cfg)
        a = n["attn"]
        caches["attn"] = (z(a, batch, max_seq, hkv, dk),
                          z(a, batch, max_seq, hkv, dv))
        if cfg.enc_dec:
            caches["attn"] += (z(a, batch, cfg.enc_seq, hkv, dk),
                               z(a, batch, cfg.enc_seq, hkv, dv))
    if n["rwkv"]:
        r, hs = n["rwkv"], cfg.rwkv_head_size
        caches["rwkv"] = (z(r, batch, 1, cfg.d_model),
                          z(r, batch, plan.n_heads_padded, hs, hs,
                            dt=torch.float32),
                          z(r, batch, 1, cfg.d_model))
    if n["mamba"]:
        m, di = n["mamba"], cfg.mamba_d_inner
        caches["mamba"] = (z(m, batch, cfg.mamba_d_conv - 1, di),
                           z(m, batch, di, cfg.mamba_d_state,
                             dt=torch.float32))
    return caches


def fill_cross_cache(params: DecoderLM, cfg: ModelConfig, plan: ShardPlan,
                     caches, enc_out, mesh=None):
    """Write each decoder layer's cross-attention K, V of ``enc_out``
    [B, enc_seq, d] (:func:`encode`'s output, through
    ``attention.cross_kv``) into Whisper's read-only cross caches, in
    place; returns ``caches``. With ``mesh``, ``caches`` and ``enc_out``
    are per shard (``models.parallel.fill_cross_cache``)."""
    if mesh is not None:
        from repro_torch.models import parallel
        return parallel.fill_cross_cache(params, cfg, plan, caches, enc_out,
                                         mesh)
    xk, xv = caches["attn"][2:]
    with torch.no_grad():
        for li, lp in enumerate(params.layers):
            k, v = attn.cross_kv(lp["xattn"], cfg, plan, enc_out)
            xk[li] = k.to(xk.dtype)
            xv[li] = v.to(xv.dtype)
    return caches


def decode_step(params: DecoderLM, cfg: ModelConfig, plan: ShardPlan,
                tokens: torch.Tensor, caches: dict, pos: int,
                impl: str = "kernel", embeds: torch.Tensor | None = None,
                mesh=None):
    """One decode step at absolute position ``pos`` (a Python int, the same
    for every sequence, as the reference's scalar). tokens [B,1];
    ``embeds`` [B,1,d] replaces the token embedding (the VLM's image
    prefix). Each layer runs :func:`apply_layer`: an attention layer
    writes its new K/V into slot ``pos`` of its cache and attends over
    slots ``0..pos`` through the paged decode (TPU kernel 5 for
    ``impl="kernel"``, ``attention.dense_window``); Whisper's layers then
    attend over their cross caches (kernel 5 over ``enc_seq`` slots); an
    RWKV6 or Mamba layer runs its recurrence at T = 1 (kernels 8 and 7)
    from the carried state, which is written back. Returns (logits
    [B,1,V], caches), the caches updated in place. With ``mesh``, the
    step runs tensor-parallel over :func:`init_decode_cache`'s per-shard
    blocks (``models.parallel.decode_step``)."""
    check_supported(cfg)
    if mesh is not None:
        from repro_torch.models import parallel
        return parallel.decode_step(params, cfg, plan, tokens, caches, pos,
                                    mesh, impl, embeds)
    dtype = getattr(torch, cfg.dtype)
    b = tokens.shape[0]
    with torch.no_grad():
        x = embed_lookup(params.embed, tokens, dtype) if embeds is None \
            else embeds.to(dtype)
        if cfg.enc_dec:
            x = x + params.dec_pos["table"][pos:pos + 1].to(dtype)[None]
        window = attn.dense_window(b, pos, x.device)
        decode = attn.mla_decode_paged if cfg.attention == "mla" \
            else attn.gqa_decode_paged
        ords = ordinals(cfg)

        def attend(j, p, h):
            kc, vc = caches["attn"][0][j], caches["attn"][1][j]
            o, _, _ = decode(p, cfg, plan, h, kc, vc, *window[:4],
                             write=window[4], impl=impl)
            return o, None

        def cross(j, p, h):
            return attn.cross_decode(p, cfg, plan, h, caches["attn"][2][j],
                                     caches["attn"][3][j], impl=impl)

        for li, (lp, kind) in enumerate(zip(params.layers,
                                            layer_kinds(cfg))):
            j = ords[li]
            pools = caches.get(kind, ()) if kind != "attn" else ()
            x, _, new = apply_layer(
                lp, cfg, plan, li, kind, x, functools.partial(attend, j),
                tuple(pool[j] for pool in pools) or None, impl=impl,
                cross=functools.partial(cross, j))
            for pool, c in zip(pools, new or ()):
                pool[j] = c
        x = apply_norm(params.final_norm, x)
        logits = lm_head(params.lm_head_params, x, cfg.vocab_size)
    return logits, caches


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, aux=0.0,
            aux_coef: float = 0.01) -> torch.Tensor:
    """Cross-entropy over the labels ``>= 0`` (``-1`` masks a position),
    in float32, plus ``aux_coef * aux`` (the MoE load-balance loss)."""
    mask = labels >= 0
    lp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(lp, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    loss = (nll * mask).sum() / mask.sum().clamp(min=1)
    return loss + aux_coef * aux
