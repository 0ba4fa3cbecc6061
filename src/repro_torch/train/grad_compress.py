"""Error-feedback int8 gradient compression for a cross-pod reduction
(counterpart of ``repro/train/grad_compress.py``).

Gradients are quantized to int8 with a per-tensor scale before the
cross-pod sum, and the quantization residual is fed back into the next
step's gradients (error feedback keeps SGD/Adam convergence). Trees are
dicts of tensors, as in ``train.optimizer``.

The reference's :func:`psum_compressed` is a ``lax.psum`` over a mesh
axis. One card has no pods: here it takes the list of every pod's
compressed tree (virtual pods, as the index's mesh has virtual shards)
and gives what each pod would hold after the sum: the int8 payloads
summed in int32, times the mean scale, over the pod count.
"""
from __future__ import annotations

import torch


def quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: ``(q, scale)`` with
    ``scale = max|g| / 127 + 1e-12`` and ``q = clip(round(g / scale),
    -127, 127)``, rounding half to even as ``jnp.round`` does."""
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_tree(grads: dict, residual: dict) -> tuple[dict, dict, dict]:
    """Quantize ``grads + residual`` leaf by leaf; return (int8 tree,
    scales, new residual ``(g + r) - dequantize(q, s)``)."""
    q, s, res = {}, {}, {}
    for name, g in grads.items():
        gf = g.to(torch.float32) + residual[name]
        q[name], s[name] = quantize_int8(gf)
        res[name] = gf - dequantize_int8(q[name], s[name])
    return q, s, res


def psum_compressed(qs: list, ss: list) -> dict:
    """The all-reduce of ``len(qs)`` pods' compressed trees (``qs[i]``,
    ``ss[i]`` pod i's int8 tree and scales): per leaf, the payloads summed
    in int32 (at most 127 times the pod count), rescaled by the mean scale
    over the pod count, a mean-of-quantized estimator."""
    n = len(qs)
    out = {}
    for name in qs[0]:
        qsum = sum(q[name].to(torch.int32) for q in qs)
        smean = sum(s[name] for s in ss) / n
        out[name] = qsum.to(torch.float32) * smean / n
    return out


def init_residual(params: dict) -> dict:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}
