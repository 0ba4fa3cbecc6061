"""Roofline terms of a dry-run cell on H100 cards (counterpart of
``repro/launch/roofline.py``: ``roofline_terms`` and ``model_flops``).

Three terms per (arch x shape x mesh), in seconds, the reference's
formula with the H100 SXM's constants in place of the TPU's:

  compute    = FLOPs / (chips x 989e12 bf16 dense tensor-core FLOP/s)
  memory     = bytes / (chips x 3.35e12 B/s HBM3)
  collective = NVLink wire bytes / (chips x 450e9 B/s)
               + network wire bytes / (chips x 50e9 B/s)

These are data-sheet values of the H100 SXM 80 GB, not measurements: a
collective whose group lies within one host's 8 cards runs on NVLink at
450 GB/s each way a card; one whose group spans hosts is priced at one
400 Gb/s NIC a card (50 GB/s). :func:`wire_path` decides which, from the
group's members under the row-major placement of shards on hosts of
``CARDS_PER_HOST``.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s a card
HBM_BW = 3.35e12             # bytes/s a card
NVLINK_BW = 450e9            # bytes/s a card each way, within a host
NET_BW = 50e9                # bytes/s a card: one 400 Gb/s NIC
CARDS_PER_HOST = 8

# ring-traffic factor: bytes on the wire per device / operand bytes (the
# reference's ``_TRAFFIC``)
TRAFFIC = {"all_reduce": 2.0, "all_gather": 1.0, "reduce_scatter": 1.0,
           "all_to_all": 1.0, "max": 2.0}


def wire_path(group: list) -> str:
    """``"nvlink"`` where every shard of ``group`` (mesh shard indices,
    placed row-major ``CARDS_PER_HOST`` to a host) is on one host, else
    ``"network"``."""
    return "nvlink" if len({s // CARDS_PER_HOST for s in group}) == 1 \
        else "network"


def roofline_terms(flops: float, bytes_accessed: float,
                   collective_wire_bytes: float, chips: int,
                   network_wire_bytes: float = 0.0) -> dict:
    """The terms of the totals over ``chips`` cards:
    ``collective_wire_bytes`` crosses NVLink, ``network_wire_bytes`` the
    hosts' network."""
    compute = flops / (chips * PEAK_FLOPS)
    memory = bytes_accessed / (chips * HBM_BW)
    collective = collective_wire_bytes / (chips * NVLINK_BW) \
        + network_wire_bytes / (chips * NET_BW)
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dom = max(terms, key=terms.get)
    bound = max(compute, memory, collective)
    terms["dominant"] = dom
    terms["roofline_bound_s"] = bound
    # fraction of the bound the compute term fills: the MFU ceiling
    terms["compute_fraction_of_bound"] = compute / bound if bound else 0.0
    return terms


def model_flops(cfg, shape) -> float:
    """Analytic model FLOPs from the *unpadded* spec (the reference's own
    arithmetic): train 6 N D, prefill 2 N D, decode 2 N B a step (MoE:
    the active parameters), plus the attention's score and value FLOPs
    per attention layer (causal ~ S^2 / 2)."""
    n_active = cfg.param_count_active()
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        base = 6.0 * n_active * b * s
    elif shape.kind == "prefill":
        base = 2.0 * n_active * b * s
    else:
        base = 2.0 * n_active * b          # one token per sequence
    attn_layers = sum(cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    dh = cfg.qk_head_dim
    if shape.kind in ("train", "prefill"):
        mult = 3 if shape.kind == "train" else 1  # bwd ~ 2x fwd
        base += mult * attn_layers * b * 2.0 * cfg.n_heads * dh * s * s
    else:
        base += attn_layers * b * 4.0 * cfg.n_heads * dh * s
    return base
