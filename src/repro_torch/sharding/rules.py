"""Per-(arch, mesh, shape) sharding plans, counterpart of
``repro/sharding/rules.py``.

The production mesh is (data=16, model=16), plus pod=2 across pods, but
the head, vocab and expert counts of the registered architectures do not
all divide 16. A ``ShardPlan`` pads them:

  * q heads to a model-axis multiple, by the cheaper of two candidates:
    (A) keep the group ratio ``g = Hq/Hkv`` and pad the KV heads too, or
    (B) pad the q heads only, to a multiple of the axis that ``Hkv``
    divides (the group ratio grows). Padded heads are inert
    (``models.attention._head_mask``).
  * KV heads shard when their count divides the axis, else replicate.
  * the vocab to a multiple of ``model * 128``; padded logits are masked
    to ``-1e30``.
  * MoE experts to a model-axis multiple; their router logits are
    ``-1e30``.

The rules table maps each logical axis (``sharding.axes``) to a mesh axis
or ``None``; ``models/parallel.py`` places tensors by it on a
``launch.mesh.ModelMesh``. Every plan equals the reference's field by
field (``dataclasses.asdict``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.utils import round_up


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    model_size: int                  # model-axis extent (1 = unsharded)
    n_heads_padded: int
    n_kv_heads_padded: int
    kv_sharded: bool
    vocab_padded: int
    n_experts_padded: int
    rules: tuple | None              # logical->mesh rules as sorted tuple
    batch_axes: tuple = ("data",)

    @property
    def rules_dict(self) -> dict | None:
        return dict(self.rules) if self.rules is not None else None

    @property
    def group_size(self) -> int:
        return self.n_heads_padded // self.n_kv_heads_padded


def _plan_heads(hq: int, hkv: int, m: int) -> tuple[int, int]:
    """Padded (q_heads, kv_heads) for model-axis extent m."""
    if hq % m == 0 and hq % hkv == 0:
        return hq, hkv
    g = max(hq // hkv, 1)
    # candidate A: preserve the group ratio, pad kv
    kv_a = hkv
    while (g * kv_a) % m != 0:
        kv_a += 1
    q_a = g * kv_a
    # candidate B: pad q only; group ratio grows
    q_b = round_up(hq, m)
    while q_b % hkv != 0:
        q_b += m
    if q_a <= q_b:
        return q_a, kv_a
    return q_b, hkv


def make_plan(cfg: ModelConfig, mesh_axes: dict[str, int] | None,
              shape_kind: str = "train",
              global_batch: int | None = None) -> ShardPlan:
    """The plan. ``mesh_axes`` e.g. ``{"data": 16, "model": 16}`` or
    ``{"pod": 2, "data": 16, "model": 16}``; ``None`` (or a model axis of
    1) is the single-device plan: nothing padded, no rules.
    ``shape_kind`` is ``train``, ``prefill`` or ``decode``;
    ``global_batch`` lets a batch the data axes do not divide (a batch of
    1) replicate over them."""
    if mesh_axes is None or mesh_axes.get("model", 1) == 1:
        return ShardPlan(
            model_size=1,
            n_heads_padded=cfg.n_heads,
            n_kv_heads_padded=cfg.n_kv_heads,
            kv_sharded=False,
            vocab_padded=cfg.vocab_size,
            n_experts_padded=cfg.n_experts,
            rules=None,
        )
    m = mesh_axes["model"]
    hq_p, hkv_p = _plan_heads(cfg.n_heads, cfg.n_kv_heads, m)
    kv_sharded = hkv_p % m == 0
    vocab_p = round_up(cfg.vocab_size, m * 128)
    ne_p = round_up(cfg.n_experts, m) if cfg.moe else 0

    dp = ("pod", "data") if "pod" in mesh_axes else ("data",)
    batch_total = 1
    for a in dp:
        batch_total *= mesh_axes[a]
    batch_shardable = global_batch is None or global_batch % batch_total == 0

    rules = {
        "batch": (dp if len(dp) > 1 else dp[0]) if batch_shardable else None,
        "seq": None,
        # sequence parallelism of the residual stream in train and
        # prefill: stored activations shard their seq dim over the model
        # axis
        "seq_sp": "model" if shape_kind in ("train", "prefill") else None,
        # decode: the KV cache shards over the model axis on its head dim
        # where the KV heads divide it (or MLA, whose padded heads always
        # do), else on head_dim ("kv_dh"). No plan shards its sequence
        # dim ("kv_seq"); only rules set by hand reach the
        # sequence-sharded decode.
        "kv_seq": None,
        "kv_dh": (
            "model" if shape_kind == "decode"
            and not (kv_sharded or cfg.attention == "mla") else None),
        "heads": "model",
        "kv_heads": "model" if kv_sharded else None,
        "embed": None,
        "mlp": "model",
        "vocab": "model",
        "expert": "model",
        "dispatch": dp if len(dp) > 1 else dp[0],
        "kv_lora": None,
        "q_lora": None,
    }
    return ShardPlan(
        model_size=m,
        n_heads_padded=hq_p,
        n_kv_heads_padded=hkv_p,
        kv_sharded=kv_sharded,
        vocab_padded=vocab_p,
        n_experts_padded=ne_p,
        rules=tuple(sorted(rules.items())),
        batch_axes=dp,
    )


def unpadded_plan(cfg: ModelConfig) -> ShardPlan:
    return make_plan(cfg, None)
