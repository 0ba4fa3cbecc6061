"""Carry configs and slab-pool state between the reference and the port.

numpy only: a reference ``SlabPoolState`` becomes ``{plane: np.ndarray}``
(``np.asarray`` per field) on its side, and :func:`state_from_numpy`
builds the port's state from that dict; :func:`state_to_numpy` goes back.
The bitmap plane's words cross as uint32 (reference) <-> int32 (port)
with the same bits, through a ``.view``. This module imports nothing of
the reference package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.pq import PQConfig
from repro_torch.core.state import PLANES, SIVFConfig, SlabPoolState
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
    if tuple(state.bitmap.shape) != (cfg.n_slabs, cfg.words):
        raise ValueError(f"bitmap shape {tuple(state.bitmap.shape)} does not "
                         f"match the config")
    return state


def state_to_numpy(state: SlabPoolState) -> dict:
    """``{plane: np.ndarray}`` on the host, the bitmap as uint32 words."""
    out = {}
    for name in PLANES:
        a = getattr(state, name).cpu().numpy()
        out[name] = a.view(np.uint32) if name == "bitmap" else a
    return out
