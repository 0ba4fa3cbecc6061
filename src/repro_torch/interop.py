"""Carry configs, slab-pool state, LM parameters and KV page state
between the reference and the port.

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
the port's layer ``l`` is position ``l % period``, entry ``l // period``.
Weights keep their ``[d_in, d_out]`` layout: a crossing only stacks and
splits, never transposes. KV page state crosses as ``{plane: array}`` of
its seven planes. This module imports nothing of the reference package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pq import PQConfig
from repro_torch.core.state import PLANES, SIVFConfig, SlabPoolState
from repro_torch.models import model as M
from repro_torch.models.common import param_group
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
        out[name] = torch.from_numpy(np.array(a, copy=True)).to(dev)
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

NORM_GROUPS = ("ln1", "ln2", "final_norm")


def _leaf(a, dev, dtype, group: str) -> torch.Tensor:
    """A numpy leaf on ``dev``; norm groups stay float32, the rest take
    ``dtype`` when one is given."""
    t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None and group not in NORM_GROUPS:
        t = t.to(dtype)
    return t.to(dev)


def params_from_numpy(cfg: ModelConfig, tree: dict, device="cuda",
                      dtype=None) -> M.DecoderLM:
    """The port's parameters on ``device`` from the reference's stripped
    param tree with numpy leaves. ``dtype`` (default: as given) is the
    storage dtype of matrices and embeddings; norm scales stay float32."""
    M.check_supported(cfg)
    dev = resolve_device(device)
    period = cfg.layer_period
    if len(tree["layers"]) != period:
        raise ValueError(f"want {period} period positions, got "
                         f"{len(tree['layers'])}")

    def group(name, leaves, pick=lambda a: a):
        return {k: _leaf(pick(a), dev, dtype, name)
                for k, a in leaves.items()}

    layers = []
    for li in range(cfg.n_layers):
        pos, p = li % period, li // period
        lt = tree["layers"][pos]
        g = {name: group(name, lt[name], lambda a: np.asarray(a)[p])
             for name in ("ln1", "attn", "ln2", "mlp")}
        layers.append(M.layer_module(
            g["ln1"], param_group(**g["attn"]), g["ln2"],
            param_group(**g["mlp"])))
    head = group("head", tree["head"]) if "head" in tree else None
    return M.DecoderLM(group("embed", tree["embed"]),
                       group("final_norm", tree["final_norm"]), layers, head)


def params_to_numpy(cfg: ModelConfig, params: M.DecoderLM) -> dict:
    """The reference's stripped param tree with numpy leaves, stacked
    ``[n_per, ...]`` per period position. bfloat16 leaves come back as
    float32, the reference's storage dtype (numpy has no bfloat16)."""
    period = cfg.layer_period

    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    tree = {"embed": {k: host(t) for k, t in params.embed.items()},
            "final_norm": {k: host(t) for k, t in params.final_norm.items()},
            "layers": []}
    if hasattr(params, "head"):
        tree["head"] = {k: host(t) for k, t in params.head.items()}
    for pos in range(period):
        stack = [params.layers[li] for li in range(pos, cfg.n_layers, period)]
        tree["layers"].append({
            name: {k: np.stack([host(lp[name][k]) for lp in stack])
                   for k in stack[0][name].keys()}
            for name in ("ln1", "attn", "ln2", "mlp")})
    return tree


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
