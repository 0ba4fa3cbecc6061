"""Carry configs, slab-pool state, LM parameters, KV page state and the
baselines' state between the reference and the port.

numpy only: a reference ``SlabPoolState`` becomes ``{plane: np.ndarray}``
(``np.asarray`` per field) on its side, and :func:`state_from_numpy`
builds the port's state from that dict; :func:`state_to_numpy` goes back.
The bitmap plane's words cross as uint32 (reference) <-> int32 (port)
with the same bits, through a ``.view``; the PQ planes (``codes`` uint8,
``pq_codebooks`` f32, trained codebooks included) and the ``attrs``
plane (int32) cross as they are, checked against the config.

LM parameters cross as the reference's stripped param tree with numpy
leaves (``{"embed": {"table": a}, "final_norm": ..., "layers": [{name:
{leaf: a[n_per, ...]}}, ...]}``, one stacked dict per period position);
the port's layer ``l`` is position ``l % period``, entry ``l // period``;
an encoder-decoder adds ``{"encoder": {"layers": {name: {leaf:
a[n_enc, ...]}}, "ln_post": ...}, "dec_pos": {"table": a}}``.
Weights keep their ``[d_in, d_out]`` layout: a crossing only stacks and
splits, never transposes. The dense decode caches
(``models.model.init_decode_cache``) cross as the reference's
``init_decode_cache`` list, one tuple per period position stacked over
the periods (MLA's latent pages as the reference's ``(latent, rope)``
pair). KV page state crosses as ``{plane: array}`` of
its seven planes, and the engine's K/V pools (MLA's latent pages
included) and recurrent-state pools (RWKV6, Mamba) as the reference
engine's per-position pools. A baseline's state crosses
as ``{plane: array}`` of the attributes :data:`BASELINE_PLANES` names
(Flat: buffer, ids, cursor; ContiguousIVF: buffer, ids, counts,
``n_relayouts``; LSH: planes, bucket vectors, ids, cursors), so that two
engines start from one state (an ``LSHIndex`` can take the reference's
``jax.random`` planes, which no torch generator draws). This module
imports nothing of the reference package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pq import PQConfig
from repro_torch.core.state import PLANES, SIVFConfig, SlabPoolState
from repro_torch.models import model as M
from repro_torch.serve import kv_cache as kvc
from repro_torch.utils import resolve_device


def config_to_dict(cfg: SIVFConfig) -> dict:
    """A JSON-able dict of ``cfg``, with ``dtype`` as its numpy name."""
    d = dataclasses.asdict(cfg)
    d["dtype"] = str(cfg.dtype).removeprefix("torch.")
    d["attributes"] = list(cfg.attributes)
    return d


def config_from_dict(d: dict) -> SIVFConfig:
    """Build a port config from a dict of the reference's fields.

    ``dtype`` may be a name (``"float32"``) or anything numpy accepts;
    ``pq`` a dict or ``None``.
    """
    d = dict(d)
    if "dtype" in d:
        d["dtype"] = getattr(torch, np.dtype(d["dtype"]).name)
    if isinstance(d.get("pq"), dict):
        d["pq"] = PQConfig(**d["pq"])
    if "attributes" in d:
        d["attributes"] = tuple(d["attributes"])
    return SIVFConfig(**d)


def state_from_numpy(cfg: SIVFConfig, planes: dict, device="cuda"
                     ) -> SlabPoolState:
    """Port state on ``device`` from ``{plane: array}`` (all 23 planes)."""
    dev = resolve_device(device)
    missing = set(PLANES) - set(planes)
    if missing:
        raise ValueError(f"missing planes: {sorted(missing)}")
    out = {}
    for name in PLANES:
        a = np.asarray(planes[name])
        if name == "bitmap":
            a = a.astype(np.uint32, copy=False).view(np.int32)
        if dev.type == "cpu" or not a.flags.writeable:
            a = np.array(a, copy=True)      # never alias the caller's array
        out[name] = torch.from_numpy(a).to(dev)
    state = SlabPoolState(**out)
    c, ps = cfg.capacity, cfg.payload_slabs
    want = {"bitmap": ((cfg.n_slabs, cfg.words), torch.int32),
            "data": ((ps, c, cfg.payload_dim), cfg.dtype),
            "codes": ((ps, c, cfg.code_m), torch.uint8),
            "pq_codebooks": (cfg.codebook_shape, torch.float32),
            "attrs": ((ps, c, cfg.n_attrs), torch.int32)}
    for name, (shape, dtype) in want.items():
        t = getattr(state, name)
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"plane {name} is {t.dtype} {tuple(t.shape)}, "
                             f"the config wants {dtype} {shape}")
    return state


def state_to_numpy(state: SlabPoolState) -> dict:
    """``{plane: np.ndarray}`` on the host, the bitmap as uint32 words."""
    out = {}
    for name in PLANES:
        a = getattr(state, name).cpu().numpy()
        out[name] = a.view(np.uint32) if name == "bitmap" else a
    return out


# ---------------------------------------------------------------------------
# LM parameters and KV page state
# ---------------------------------------------------------------------------

def _leaf(a, dev, dtype, group: str, name: str) -> torch.Tensor:
    """A numpy leaf on ``dev``; the float32 leaves (``M.FLOAT32_LEAVES``)
    stay float32, the rest take ``dtype`` when one is given."""
    t = torch.from_numpy(np.array(a, copy=True))
    keep = M.FLOAT32_LEAVES.get(group, ())
    if dtype is not None and not (keep is None or name in keep):
        t = t.to(dtype)
    return t.to(dev)


def params_from_numpy(cfg: ModelConfig, tree: dict, device="cuda",
                      dtype=None) -> M.DecoderLM:
    """The port's parameters on ``device`` from the reference's stripped
    param tree with numpy leaves. ``dtype`` (default: as given) is the
    storage dtype of matrices and embeddings; the float32 leaves (norm
    scales, RWKV's ``w0``/``u``/group norm, Mamba's ``a_log``/``dt_bias``/
    ``d``, the attention's ``q_norm``/``k_norm`` and MLA's ``q_ln``/
    ``kv_ln``) stay float32. Every group of a layer crosses: ``ln1``,
    ``attn`` (GQA or MLA) | ``tm`` | ``mamba``, ``ln2``, ``mlp`` | ``cm`` |
    ``moe`` (with its nested ``shared`` group), and Whisper's ``ln_x``,
    ``xattn``, ``encoder`` and ``dec_pos``."""
    M.check_supported(cfg)
    dev = resolve_device(device)
    period = cfg.layer_period
    if len(tree["layers"]) != period:
        raise ValueError(f"want {period} period positions, got "
                         f"{len(tree['layers'])}")

    def group(name, leaves, pick=lambda a: a):
        """A group's leaves; a nested group (the MoE's ``shared``) takes
        its parent's float32 rule."""
        return {k: group(name, a, pick) if isinstance(a, dict) else
                _leaf(pick(a), dev, dtype, name, k)
                for k, a in leaves.items()}

    layers = []
    for li in range(cfg.n_layers):
        pos, p = li % period, li // period
        lt = tree["layers"][pos]
        layers.append(M.layer_module(**{
            name: group(name, lt[name], lambda a: np.asarray(a)[p])
            for name in lt}))
    head = group("head", tree["head"]) if "head" in tree else None
    encoder = dec_pos = None
    if cfg.enc_dec:
        et = tree["encoder"]
        n_enc = len(next(iter(et["layers"]["ln1"].values())))
        encoder = {"layers": [M.layer_module(**{
            name: group(name, g, lambda a, i=i: np.asarray(a)[i])
            for name, g in et["layers"].items()}) for i in range(n_enc)],
            "ln_post": group("ln_post", et["ln_post"])}
        dec_pos = group("dec_pos", tree["dec_pos"])
    return M.DecoderLM(group("embed", tree["embed"]),
                       group("final_norm", tree["final_norm"]), layers, head,
                       encoder, dec_pos)


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy; bfloat16 comes back as float32 (numpy has none)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def params_to_numpy(cfg: ModelConfig, params: M.DecoderLM) -> dict:
    """The reference's stripped param tree with numpy leaves, stacked
    ``[n_per, ...]`` per period position. bfloat16 leaves come back as
    float32, the reference's storage dtype."""
    period = cfg.layer_period
    tree = {"embed": {k: _host(t) for k, t in params.embed.items()},
            "final_norm": {k: _host(t)
                           for k, t in params.final_norm.items()},
            "layers": []}
    if hasattr(params, "head"):
        tree["head"] = {k: _host(t) for k, t in params.head.items()}

    def stacked(groups):                # one group over the periods
        return {k: stacked([g[k] for g in groups])
                if isinstance(v, torch.nn.ParameterDict) else
                np.stack([_host(g[k]) for g in groups])
                for k, v in groups[0].items()}

    for pos in range(period):
        stack = [params.layers[li] for li in range(pos, cfg.n_layers, period)]
        tree["layers"].append({name: stacked([lp[name] for lp in stack])
                               for name in stack[0].keys()})
    if cfg.enc_dec:
        enc = params.encoder
        tree["encoder"] = {
            "layers": {name: stacked([lp[name] for lp in enc["layers"]])
                       for name in enc["layers"][0].keys()},
            "ln_post": {k: _host(t) for k, t in enc["ln_post"].items()}}
        tree["dec_pos"] = {k: _host(t) for k, t in params.dec_pos.items()}
    return tree


def recurrent_state_to_numpy(cfg: ModelConfig, pools: dict) -> list:
    """The engine's recurrent-state pools in the reference engine's layout:
    one entry per period position, ``None`` for an attention position, else
    the tuple of that position's pools stacked over the periods,
    ``[n_per, max_seqs, ...]`` (rwkv: time-mix ``x_prev``, ``S``,
    channel-mix ``x_prev``; mamba: conv state, ``h``). ``pools`` maps a
    kind to its tuple of ``[n_kind, max_seqs, ...]`` tensors (the engine's
    ``state``). bfloat16 comes back as float32."""
    kinds, ords, period = M.layer_kinds(cfg), M.ordinals(cfg), \
        cfg.layer_period
    out = []
    for pos in range(period):
        layers = range(pos, cfg.n_layers, period)
        kind = kinds[pos]
        out.append(None if kind == "attn" else tuple(
            np.stack([_host(pool[ords[li]]) for li in layers])
            for pool in pools[kind]))
    return out


def kv_pools_to_numpy(cfg: ModelConfig, *pools: torch.Tensor) -> list:
    """The engine's K and V pools (``[n_attn, n_pages, page, Hkv, d]``) in
    the reference engine's layout: one entry per period position, ``None``
    where the position is no attention layer, else ``(k, v)`` stacked over
    the periods, ``[n_per, n_pages, page, Hkv, d]``. MLA's latent pages
    cross the same way (``Hkv = 1``, K ``latent (+) rope``, V ``latent``).
    Any stacks over the attention layers cross so (the dense decode's
    caches, Whisper's cross caches among them). bfloat16 comes back as
    float32."""
    kinds, ords, period = M.layer_kinds(cfg), M.ordinals(cfg), \
        cfg.layer_period
    return [None if kinds[pos] != "attn" else tuple(
        np.stack([_host(pool[ords[li]])
                  for li in range(pos, cfg.n_layers, period)])
        for pool in pools) for pos in range(period)]


def decode_cache_to_numpy(cfg: ModelConfig, caches: dict) -> list:
    """The port's dense decode caches (``models.model.init_decode_cache``)
    in the reference's ``init_decode_cache`` layout: one tuple per period
    position, each array stacked over the periods ``[n_per, B, ...]``
    (:func:`kv_pools_to_numpy`, :func:`recurrent_state_to_numpy`). MLA's
    latent-page K ``latent (+) rope`` becomes the reference's ``(latent,
    rope)``. bfloat16 comes back as float32."""
    parts = caches.get("attn", ())
    if parts and cfg.attention == "mla":
        lat = cfg.kv_lora_rank
        parts = (parts[0][..., 0, :lat], parts[0][..., 0, lat:])
    return [a if a is not None else r for a, r in zip(
        kv_pools_to_numpy(cfg, *parts), recurrent_state_to_numpy(cfg,
                                                                  caches))]


def recurrent_state_from_numpy(cfg: ModelConfig, entries: list,
                               device="cuda", dtype=None) -> dict:
    """The inverse of :func:`recurrent_state_to_numpy`: ``{kind: tuple of
    [n_kind, max_seqs, ...] tensors}`` on ``device``. The float32 states
    (``S``, ``h``) stay float32; the token-shift and conv states take
    ``dtype`` when one is given."""
    dev = resolve_device(device)
    kinds, period = M.layer_kinds(cfg), cfg.layer_period
    if len(entries) != period:
        raise ValueError(f"want {period} period positions, got "
                         f"{len(entries)}")
    out = {}
    for kind in M.kinds_present(cfg):
        if kind == "attn":
            continue
        layers = [li for li in range(cfg.n_layers) if kinds[li] == kind]
        parts = []
        for j in range(len(entries[layers[0] % period])):
            t = torch.from_numpy(np.stack([      # layer order = ordinal
                np.asarray(entries[li % period][j])[li // period]
                for li in layers]))
            if dtype is not None and j != 1:     # S and h: float32
                t = t.to(dtype)
            parts.append(t.to(dev))
        out[kind] = tuple(parts)
    return out


def page_state_from_numpy(planes: dict, device="cuda") -> kvc.PageState:
    """Port page state on ``device`` from ``{plane: array}`` (all seven)."""
    dev = resolve_device(device)
    missing = set(kvc.PLANES) - set(planes)
    if missing:
        raise ValueError(f"missing planes: {sorted(missing)}")
    return kvc.PageState(**{
        name: torch.from_numpy(np.array(planes[name], copy=True)).to(dev)
        for name in kvc.PLANES})


def page_state_to_numpy(st: kvc.PageState) -> dict:
    """``{plane: np.ndarray}`` on the host: a copy, so it does not follow
    the state's in-place updates."""
    return {name: getattr(st, name).cpu().numpy().copy()
            for name in kvc.PLANES}


# the attributes that make up each baseline engine's state, by class name
# (``repro_torch.baselines``, whose names the reference's engines share);
# tensors cross as their dtype, the host integers (Flat's cursor,
# ContiguousIVF's n_relayouts) as 0-d arrays
BASELINE_PLANES = {
    "FlatIndex": ("buf", "ids", "cursor"),
    "ContiguousIVF": ("buf", "ids", "counts", "n_relayouts"),
    "LSHIndex": ("planes", "bucket_vecs", "bucket_ids", "cursors"),
}


def baseline_state_to_numpy(engine) -> dict:
    """``{plane: np.ndarray}`` of a Flat, ContiguousIVF or LSH engine: a
    copy on the host."""
    out = {}
    for name in BASELINE_PLANES[type(engine).__name__]:
        v = getattr(engine, name)
        out[name] = v.cpu().numpy().copy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
    return out


def load_baseline_state(engine, planes: dict):
    """Set ``engine``'s state from ``{plane: array}`` (all its planes, as
    numpy, the reference's arrays included), each tensor on the engine's
    device in the dtype it has there; returns the engine."""
    names = BASELINE_PLANES[type(engine).__name__]
    missing = set(names) - set(planes)
    if missing:
        raise ValueError(f"missing planes: {sorted(missing)}")
    for name in names:
        cur, a = getattr(engine, name), np.array(planes[name], copy=True)
        if not isinstance(cur, torch.Tensor):
            setattr(engine, name, int(a))
            continue
        t = torch.from_numpy(a)
        if t.dtype != cur.dtype:
            raise ValueError(f"{name}: dtype {t.dtype}, want {cur.dtype}")
        setattr(engine, name, t.to(cur.device))
    return engine
