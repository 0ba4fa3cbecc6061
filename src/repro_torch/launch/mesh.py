"""The LM's model mesh and its collectives (counterpart of
``repro/launch/mesh.py``).

A :class:`ModelMesh` is the index mesh's idiom (``core.distributed.
ShardMesh``: a frozen tuple of ``torch.device``s, devices may repeat)
over named axes: ``data``, ``model`` and optionally ``pod``, shard ``s``
at the row-major coordinate ``s`` of ``shape``. ``ModelMesh.virtual(
{"data": 2, "model": 4}, "cuda")`` puts eight shards on one card (the
counterpart of ``--xla_force_host_platform_device_count=8``); a mesh of
distinct devices runs one shard per device with the same code.

The reference's GSPMD step inserts its collectives where the shardings
ask for them; the port's mesh program (``models/parallel.py``) calls them
by name, each through :func:`collective`, in shard order, so a sum over
the model shards adds them in their order on the axis.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math

import torch

AXIS_ORDER = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class ModelMesh:
    """``axes``: ``((name, extent), ...)`` in ``AXIS_ORDER``; ``devices``:
    one per shard, row-major over the axes."""

    axes: tuple
    devices: tuple

    def __post_init__(self):
        axes = tuple((str(a), int(n)) for a, n in self.axes)
        names = [a for a, _ in axes]
        if names != [a for a in AXIS_ORDER if a in names] or \
                "model" not in names or "data" not in names:
            raise ValueError(f"axes {names}: want data, model (and pod "
                             f"first) in the order {AXIS_ORDER}")
        if any(n < 1 for _, n in axes):
            raise ValueError(f"axis extents must be >= 1: {axes}")
        devs = tuple(torch.device(d) for d in self.devices)
        if len(devs) != math.prod(n for _, n in axes):
            raise ValueError(f"{len(devs)} devices for the shape {axes}")
        object.__setattr__(self, "axes", axes)
        object.__setattr__(self, "devices", devs)

    @classmethod
    def virtual(cls, shape: dict, device="cuda") -> "ModelMesh":
        """Every shard of ``shape`` (``{axis: extent}``) on one device."""
        axes = tuple((a, shape[a]) for a in AXIS_ORDER if a in shape)
        if set(shape) - set(AXIS_ORDER):
            raise ValueError(f"unknown axes {set(shape) - set(AXIS_ORDER)}")
        return cls(axes, (torch.device(device),) * math.prod(shape.values()))

    @property
    def shape(self) -> dict:
        return dict(self.axes)

    @property
    def size(self) -> int:
        return len(self.devices)

    def coord(self, s: int) -> dict:
        """Shard ``s``'s coordinate ``{axis: index}``."""
        out = {}
        for a, n in reversed(self.axes):
            s, out[a] = divmod(s, n)
        return {a: out[a] for a, _ in self.axes}

    def index(self, coord: dict) -> int:
        """The shard at ``coord`` (every axis named)."""
        s = 0
        for a, n in self.axes:
            s = s * n + coord[a]
        return s

    def extent(self, axes) -> int:
        """The product of the extents of ``axes`` (a name or names)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape[a] for a in axes)

    def position(self, s: int, axes) -> int:
        """Shard ``s``'s row-major position along ``axes`` (a name or
        names, ``()`` gives 0)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        c, p = self.coord(s), 0
        for a in axes:
            p = p * self.shape[a] + c[a]
        return p

    def groups(self, axes) -> list:
        """The shards that differ only along ``axes``, each group in its
        row-major order along them: the members of one collective."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        rest = [a for a, _ in self.axes if a not in axes]
        out = []
        for fixed in itertools.product(*(range(self.shape[a])
                                         for a in rest)):
            c = dict(zip(rest, fixed))
            members = []
            for along in itertools.product(*(range(self.shape[a])
                                             for a in axes)):
                c.update(zip(axes, along))
                members.append(self.index(c))
            out.append(members)
        return out


def make_production_mesh(*, multi_pod: bool = False) -> ModelMesh:
    """The reference's production shapes as a shape only (every shard on
    the ``meta`` device): (data=16, model=16), 256 chips; with
    ``multi_pod`` (pod=2, data=16, model=16), 512."""
    shape = {"data": 16, "model": 16}
    if multi_pod:
        shape = {"pod": 2, **shape}
    return ModelMesh.virtual(shape, "meta")


def mesh_axes_dict(mesh: ModelMesh) -> dict[str, int]:
    return mesh.shape


def _identity(arg) -> tuple:
    """An argument's identity: a tensor's, a group's or a tuple's tensors';
    a slice or a number by its value."""
    if isinstance(arg, dict):
        return tuple(id(v) for v in arg.values())
    if isinstance(arg, (tuple, list)):
        return tuple(id(v) for v in arg)
    if isinstance(arg, (slice, int)):
        return (arg,)
    return (id(arg),)


_share = [True]      # False inside :func:`each_shard_alone`


@contextlib.contextmanager
def each_shard_alone():
    """While entered, :func:`replicated` calls ``fn`` for every shard, as
    each device of a real mesh runs its own copy (``launch.op_count``
    counts a device's work so)."""
    _share.append(False)
    try:
        yield
    finally:
        _share.pop()


def replicated(fn, *lists) -> list:
    """``fn`` over each shard's arguments (``lists[i][s]``), called once
    for each distinct tuple of argument objects: shards that hold the same
    tensors (on one device, replicated over an axis) share the result,
    which each would compute equal (unless :func:`each_shard_alone`)."""
    memo, out = {}, []
    for s, args in enumerate(zip(*lists)):
        key = tuple(_identity(a) for a in args) if _share[-1] else s
        if key not in memo:
            memo[key] = fn(*args)
        out.append(memo[key])
    return out


def collective(op: str, xs: list, mesh: ModelMesh, axes, dim: int = 0,
               concat_dim: int | None = None) -> list:
    """One collective over ``axes`` of ``mesh`` on the per-shard tensors
    ``xs`` (``xs[s]`` on ``mesh.devices[s]``); returns the per-shard
    results, each on its shard's device. Shards on one device may share a
    result tensor: treat results as read-only.

    * ``all_reduce``: the sum of the group's tensors, added in the
      group's order in float32 and rounded once to their dtype (``psum``;
      a bf16 running sum would round once per shard);
    * ``max``: their elementwise maximum (``pmax``);
    * ``all_gather``: their concatenation along ``dim``;
    * ``reduce_scatter``: member ``k`` of ``n`` gets chunk ``k`` of the
      sum along ``dim``;
    * ``all_to_all``: each tensor cut into ``n`` chunks along ``dim``,
      chunk ``k`` sent to member ``k``, which concatenates what it
      receives along ``concat_dim`` in the senders' order (``lax.
      all_to_all(..., split_axis=dim, concat_axis=concat_dim,
      tiled=True)``).
    """
    out = [None] * mesh.size
    for group in mesh.groups(axes):
        n = len(group)
        if n == 1 and op != "all_to_all":
            out[group[0]] = xs[group[0]]
            continue
        home = mesh.devices[group[0]]
        parts = [xs[s].to(home) for s in group]
        if op == "all_to_all":
            cuts = [p.chunk(n, dim) for p in parts]
            for k, s in enumerate(group):
                out[s] = torch.cat([c[k] for c in cuts], concat_dim)
            continue
        if op in ("all_reduce", "reduce_scatter"):
            acc = parts[0].float()
            for p in parts[1:]:
                acc = acc + p.float()
            acc = acc.to(parts[0].dtype)
        elif op == "max":
            acc = parts[0]
            for p in parts[1:]:
                acc = torch.maximum(acc, p)
        elif op == "all_gather":
            acc = torch.cat(parts, dim)
        else:
            raise ValueError(f"unknown collective {op!r}")
        pieces = acc.chunk(n, dim) if op == "reduce_scatter" else [acc] * n
        for k, s in enumerate(group):
            out[s] = pieces[k]
    return [t.to(mesh.devices[s]) for s, t in enumerate(out)]
