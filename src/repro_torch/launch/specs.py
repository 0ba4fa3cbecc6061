"""How a plan reaches tensors: input, parameter and cache specs, and the
split of parameters over a model mesh (counterpart of
``repro/launch/specs.py``).

A spec is ``sharding.axes``'s tuple (one mesh axis name, tuple of names
or ``None`` per dim); a tensor's block on shard ``s`` is, along each dim
its spec names, chunk ``mesh.position(s, axes)`` of ``mesh.extent(axes)``
equal chunks. The abstract trees live on the ``meta`` device: shapes and
dtypes, no storage.

A leaf of ``PARTS`` splits its product's output into equal parts that the
model uses apart (Mamba's ``w_in`` ``[d, 2 di]`` gives ``xin`` and
``z``): its block is a tuple, the shard's chunk of each part along the
last dim, one view a part, so a shard holds ``di/m`` columns of ``xin``
and its columns of ``z``, where chunk ``s`` of ``2 di`` would hold one
half only.
"""
from __future__ import annotations

import torch

from repro_torch.configs import ShapeConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import ModelMesh
from repro_torch.models import model as M
from repro_torch.models.mamba import PARTS
from repro_torch.sharding.axes import logical_axes, spec_for
from repro_torch.sharding.rules import ShardPlan


def input_shardings(cfg: ModelConfig, shape: ShapeConfig, plan: ShardPlan,
                    mesh: ModelMesh | None = None) -> dict:
    """The inputs' specs: the batch dim on the plan's ``batch`` rule."""
    rules = plan.rules_dict
    bspec = (rules["batch"], None) if rules else ()
    out = {"tokens": bspec}
    if shape.kind == "train":
        out["labels"] = bspec
    extra = (rules["batch"], None, None) if rules else ()
    if cfg.frontend == "vision_stub" and shape.kind != "decode":
        out["prefix_embeds"] = extra
    if cfg.enc_dec and shape.kind != "decode":
        out["enc_frames"] = extra
    return out


def abstract_params(cfg: ModelConfig, plan: ShardPlan, max_seq: int,
                    dtype=None) -> M.DecoderLM:
    """The parameters on the ``meta`` device (``init_params``'s shapes and
    storage dtypes; ``dtype=torch.float32`` stores every leaf in float32,
    as the reference's tree does)."""
    return M.init_params(cfg, plan, device="meta", max_seq=max_seq,
                         dtype=dtype)


def cache_shardings(cfg: ModelConfig, plan: ShardPlan, cache_abs=None,
                    mesh: ModelMesh | None = None) -> list:
    """The reference's decode-cache specs, one tuple per period position
    of its ``init_decode_cache`` (``cache_abs`` is not needed: the
    entries follow from ``cfg``). Attention K, V: ``(None, batch, kv_seq,
    kv_heads, kv_dh)``, and Whisper's cross K, V alike; MLA's latent and
    rope caches ``(None, batch, None, mlp)``; RWKV's ``x_prev``, ``S``
    (on heads), channel-mix ``x_prev``; Mamba's conv and SSM states on
    ``mlp``. The port's dense cache keeps a GQA layer's K, V in this
    layout per shard (``models.parallel.init_decode_cache``)."""
    rules = plan.rules_dict or {}

    def ns(*ax):
        return spec_for(ax, rules)

    out = []
    for pos in range(cfg.layer_period):
        if cfg.attention == "mla" and cfg.is_attn_layer(pos):
            lat = ns(None, "batch", None, "mlp")
            out.append((lat, lat))
        elif cfg.is_attn_layer(pos) or cfg.enc_dec:
            kv = ns(None, "batch", "kv_seq", "kv_heads", "kv_dh")
            out.append((kv,) * (4 if cfg.enc_dec else 2))
        elif cfg.block == "rwkv":
            out.append((ns(None, "batch", None, None),
                        ns(None, "batch", "heads", None, None),
                        ns(None, "batch", None, None)))
        elif cfg.block == "hybrid":
            out.append((ns(None, "batch", None, "mlp"),
                        ns(None, "batch", "mlp", None)))
        else:
            out.append((ns(None, None),))
    return out


def param_shardings(params, mesh: ModelMesh | None, rules: dict | None
                    ) -> dict:
    """``{name: spec}`` of a ``DecoderLM``'s parameters (or of a
    ``{name: logical axes}`` map) under ``rules``. With a mesh, every axis
    a spec names must be one of its axes."""
    axes = params if isinstance(params, dict) else logical_axes(params)
    specs = {n: spec_for(a, rules) for n, a in axes.items()}
    if mesh is not None:
        named = {a for sp in specs.values() for e in sp if e is not None
                 for a in ((e,) if isinstance(e, str) else e)}
        if named - set(mesh.shape):
            raise ValueError(f"specs name {named - set(mesh.shape)}, not "
                             f"axes of the mesh {mesh.shape}")
    return specs


def parts_of(name: str) -> int:
    """The parts a parameter's last dim holds (``PARTS``; 1 for most)."""
    *path, leaf = name.split(".")
    return PARTS.get(path[-1] if path else "", {}).get(leaf, 1)


def block(t: torch.Tensor, spec: tuple, mesh: ModelMesh, s: int,
          parts: int = 1):
    """Shard ``s``'s block of ``t`` under ``spec``: a view where it stays
    on ``t``'s device (a row block is contiguous, a column block strided),
    else a copy on the shard's device. With ``parts``, the last dim holds
    ``parts`` equal parts and the block is a tuple: the shard's block of
    each part. Raises ``ValueError`` where an extent does not divide its
    dim."""
    if parts > 1:
        return tuple(block(c, spec, mesh, s) for c in t.chunk(parts, -1))
    for d, e in enumerate(spec):
        if e is None:
            continue
        n, k = mesh.extent(e), mesh.position(s, e)
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split "
                             f"into {n} ({e})")
        size = t.shape[d] // n
        t = t.narrow(d, k * size, size)
    return t.to(mesh.devices[s])


def shard_params(params, specs: dict, mesh: ModelMesh) -> list:
    """Every shard's blocks of ``params`` (a ``DecoderLM``), one nested
    dict a shard named as the module (``sp["layers"][3]["attn"]["wq"]``,
    ``sp["embed"]["table"]``), so shard code reads a group as it reads the
    module's. On a virtual mesh each block is a view of the padded tensor:
    nothing is held twice, and gradients through the blocks land in the
    tensor's own."""
    named = dict(params.named_parameters())
    out = []
    for s in range(mesh.size):
        tree: dict = {}
        for name, t in named.items():
            *path, leaf = name.split(".")
            node = tree
            for i, key in enumerate(path):
                if key.isdigit():
                    lst = node
                    idx = int(key)
                    while len(lst) <= idx:
                        lst.append({})
                    node = lst[idx]
                else:
                    nxt = path[i + 1] if i + 1 < len(path) else None
                    node = node.setdefault(
                        key, [] if nxt is not None and nxt.isdigit() else {})
            node[leaf] = block(t, specs[name], mesh, s, parts_of(name))
        out.append(tree)
    return out


def assemble(blocks: dict, spec: tuple) -> torch.Tensor:
    """A tensor from its distinct blocks under ``spec``: ``{key: block}``,
    ``key`` the block's index along each dim (0 where the spec names no
    axis); each named dim concatenated in index order."""
    for d in reversed(range(len(spec))):
        if spec[d] is None:
            continue
        merged: dict = {}
        for k in sorted(blocks):
            merged.setdefault(k[:d] + (0,) + k[d + 1:], []).append(blocks[k])
        blocks = {k: torch.cat(v, d) for k, v in merged.items()}
    return blocks[(0,) * len(spec)]


def gather_params(shards: list, specs: dict, mesh: ModelMesh) -> dict:
    """``{name: tensor}`` put back together from :func:`shard_params`'s
    blocks (on shard 0's device), replicas read once."""
    out = {}
    for name, spec in specs.items():
        *path, leaf = name.split(".")
        parts = parts_of(name)
        blocks = {}
        for s in range(mesh.size):
            key = tuple(0 if e is None else mesh.position(s, e)
                        for e in spec)
            if key not in blocks:
                node = shards[s]
                for k in path:
                    node = node[int(k)] if k.isdigit() else node[k]
                b = node[leaf]
                blocks[key] = b.to(mesh.devices[0]) if parts == 1 else \
                    tuple(t.to(mesh.devices[0]) for t in b)
        if parts == 1:
            out[name] = assemble(blocks, spec)
        else:                  # each part put together, then the parts
            out[name] = torch.cat([assemble(
                {k: b[i] for k, b in blocks.items()}, spec)
                for i in range(parts)], -1)
    return out
