"""Single-device shard plan, counterpart of ``repro/sharding/rules.py``.

The reference pads head, vocab and expert counts so they shard over a
model mesh axis. One card has no mesh: the plan this module builds is the
reference's ``make_plan(cfg, None)`` (``model_size=1``, nothing padded,
no rules), and the reference's ``constrain``/``annot`` calls have no
counterpart in the port. A plan for a mesh raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig

ROADMAP_MESH = ("ROADMAP.md queue 1 item 10b (the LM's model-axis plan, "
                "sharding/{axes,rules}.py)")


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    model_size: int                  # model-axis extent (1 = unsharded)
    n_heads_padded: int
    n_kv_heads_padded: int
    kv_sharded: bool
    vocab_padded: int
    n_experts_padded: int
    rules: tuple | None              # logical->mesh rules (None: no mesh)
    batch_axes: tuple = ("data",)

    @property
    def group_size(self) -> int:
        return self.n_heads_padded // self.n_kv_heads_padded


def make_plan(cfg: ModelConfig, mesh_axes: dict[str, int] | None
              ) -> ShardPlan:
    """The single-device plan (``mesh_axes`` None or a model axis of 1).
    The reference's ``shape_kind`` and ``global_batch`` only matter on a
    mesh, so they have no counterpart."""
    if mesh_axes is not None and mesh_axes.get("model", 1) != 1:
        raise NotImplementedError(
            f"a mesh plan ({mesh_axes}) is not ported: {ROADMAP_MESH}")
    return ShardPlan(
        model_size=1,
        n_heads_padded=cfg.n_heads,
        n_kv_heads_padded=cfg.n_kv_heads,
        kv_sharded=False,
        vocab_padded=cfg.vocab_size,
        n_experts_padded=cfg.n_experts,
        rules=None,
    )


def unpadded_plan(cfg: ModelConfig) -> ShardPlan:
    return make_plan(cfg, None)
