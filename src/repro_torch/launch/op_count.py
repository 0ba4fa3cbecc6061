"""What one device of a model mesh does in a step, counted on the ``meta``
device: the port's counterpart of ``repro/launch/hlo_analyzer.py``.

The reference compiles a cell and reads the post-SPMD HLO (FLOPs of
every dot and convolution, operand and result bytes of every top-level
op, collectives by kind with trip counts). The port has no HLO: its mesh
program (``models/parallel.py``) runs shard by shard in eager PyTorch, so
:func:`counting` runs that program on ``meta`` tensors (shapes, no
storage) and counts what it dispatches:

  * **FLOPs** of every matrix product (``torch.utils.flop_counter``'s
    formulas: ``mm``, ``bmm``, ``addmm``, the einsums they carry);
  * **bytes** read and written by every aten op that is not a view:
    its tensor inputs and outputs, each op on its own (eager: no fusion
    assumed, where XLA's fusions keep their inner values on chip);
  * **the collectives** by kind, recorded at ``launch.mesh.collective``:
    calls, operand bytes a device, wire bytes (``roofline.TRAFFIC``) on
    NVLink or the network (``roofline.wire_path`` of the group on the
    production mesh);
  * **each kernel's work** from its own formula (``kernels._meta``: the
    ``meta`` route of kernels 5-8, the formulas ``chip_smoke.py`` bounds
    them with);
  * **the peak of live bytes**: the ``meta`` tensors the run creates and
    still holds, at their largest.

Every shard runs its own copy of the replicated work
(``launch.mesh.each_shard_alone``), as every device does, so each total
divided by the shards run is a device's. Shards that differ only on
``data`` or ``pod`` hold the same shapes, so a cell may run on a mesh
whose ``data`` and ``pod`` extents are 1 with one data shard's rows
(``production`` names the mesh whose collective groups are priced): an
``all_gather`` over those axes then returns the production group's
extent of blocks (on ``meta`` tensors only the shapes matter), so what
follows it (the rows an MoE fallback routes, the gathered logits) has
the production shapes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _meta
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import ModelMesh

_aten = torch.ops.aten
# ops that move no data of their own
_FREE = {_aten.detach.default, _aten.alias.default,
         _aten.lift_fresh.default, _aten.empty.memory_format,
         _aten.empty_like.default, _aten.new_empty.default,
         _aten.empty_strided.default}


@dataclasses.dataclass
class Counts:
    """Totals over the shards run (``shards``); :meth:`per_device`
    divides them."""

    shards: int
    flops: float = 0.0
    bytes: float = 0.0
    kernels: dict = dataclasses.field(default_factory=dict)
    collectives: dict = dataclasses.field(default_factory=dict)
    live: float = 0.0
    peak_live: float = 0.0

    def per_device(self) -> dict:
        n = self.shards
        return {
            "flops": (self.flops + sum(k["flops"] for k in
                                       self.kernels.values())) / n,
            "matmul_flops": self.flops / n,
            "memory_bytes": (self.bytes + sum(k["bytes"] for k in
                                              self.kernels.values())) / n,
            "kernels": {name: {key: v / n for key, v in k.items()}
                        for name, k in self.kernels.items()},
            "collectives": {op: {key: v / n for key, v in c.items()}
                            for op, c in self.collectives.items()},
            "collective_wire_bytes": sum(
                c["wire_bytes"] for c in self.collectives.values()) / n,
            "network_wire_bytes": sum(
                c["network_wire_bytes"] for c in self.collectives.values())
            / n,
            "peak_live_bytes": self.peak_live / n}


class _Count(TorchDispatchMode):
    """FLOPs of every matrix product; bytes in and out of every aten op
    that is not a view, and the live bytes of the tensors the ops
    create."""

    def __init__(self, counts: Counts):
        super().__init__()
        self.counts, self.paused = counts, 0

    def _free(self, n: int) -> None:
        self.counts.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused or func in _FREE or getattr(func, "is_view", False):
            return out
        flops = flop_registry.get(func.overloadpacket)
        if flops is not None:
            self.counts.flops += flops(*args, **kwargs, out_val=out)
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        c = self.counts
        c.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        seen = {id(t) for t in ins}
        for t in outs:
            if id(t) in seen or t._is_view():
                continue
            n = t.numel() * t.element_size()
            c.live += n
            weakref.finalize(t, self._free, n)
        c.peak_live = max(c.peak_live, c.live)
        return out


@contextlib.contextmanager
def counting(mesh: ModelMesh, production: ModelMesh | None = None):
    """Count what runs while entered on ``mesh`` (a ``meta`` mesh); yields
    the :class:`Counts`, complete on exit. A collective over axes whose
    ``production`` extent is 1 is not one; the rest are priced on the
    ``production`` group (default ``mesh``)."""
    prod = production or mesh
    counts = Counts(shards=mesh.size)
    mode = _Count(counts)
    orig = mesh_mod.collective

    def kernel(name: str, flops: int, bytes_: int) -> None:
        k = counts.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                             "bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += bytes_

    def collective(op, xs, m, axes, dim=0, concat_dim=None):
        n = prod.extent(axes)
        if n > 1:
            group = prod.groups(axes)[0]
            operand = sum(x.numel() * x.element_size() for x in xs)
            c = counts.collectives.setdefault(op, {
                "count": 0, "bytes": 0, "wire_bytes": 0,
                "network_wire_bytes": 0})
            c["count"] += m.size
            c["bytes"] += operand
            wire = R.TRAFFIC[op] * operand
            c["wire_bytes" if R.wire_path(group) == "nvlink"
              else "network_wire_bytes"] += wire
        mode.paused += 1
        try:
            out = orig(op, xs, m, axes, dim, concat_dim)
            k = n // m.extent(axes)
            if op == "all_gather" and k > 1:    # the production group's
                out = [torch.cat([t] * k, dim) for t in out]
            return out
        finally:
            mode.paused -= 1

    mesh_mod.collective = collective
    try:
        with mesh_mod.each_shard_alone(), _meta.recording(kernel), \
                _nonzero_all(), mode:
            yield counts
    finally:
        mesh_mod.collective = orig


@contextlib.contextmanager
def _nonzero_all():
    """``nonzero`` on ``meta`` as if every element were non-zero (a meta
    tensor holds no values: the MoE dispatch counts every pair kept, an
    upper bound)."""
    import torch.fx.experimental._config as fx_config
    prev = fx_config.meta_nonzero_assume_all_nonzero
    fx_config.meta_nonzero_assume_all_nonzero = True
    try:
        yield
    finally:
        fx_config.meta_nonzero_assume_all_nonzero = prev
