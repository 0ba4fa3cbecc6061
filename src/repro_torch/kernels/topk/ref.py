"""Plain PyTorch top-k selection: the oracle for ``csrc/topk.cu``.

Counterpart of ``repro/kernels/topk/ref.py::topk_ref`` (``lax.top_k`` of
``-dists``): the ``k`` smallest distances of each row in ascending order,
and the label at each chosen column. Distances are ordered as XLA's top-k
orders them on the CPU, by IEEE total order (``-0.0`` before ``+0.0``),
and equal distances by the lower column. A chosen ``+inf`` keeps its own
label: no ``-1`` is forced (unlike ``sivf_scan.ref.fold_topk``; on the
unfused scan's output every ``+inf`` already carries ``-1``). The order
is a stable sort of an int32 key whose order is the total order; unlike
``torch.topk``, it is stable on ties. NaN is outside the contract.
"""
from __future__ import annotations

import torch


def check_operands(dists: torch.Tensor, labels: torch.Tensor, k: int
                   ) -> None:
    """Raise unless ``dists`` is float32 and ``labels`` int32, both
    contiguous ``[Q, L]`` of one shape, and ``1 <= k <= L``."""
    if dists.dtype != torch.float32 or labels.dtype != torch.int32:
        raise ValueError(f"want float32 dists and int32 labels, got "
                         f"{dists.dtype} and {labels.dtype}")
    if dists.dim() != 2 or dists.shape != labels.shape:
        raise ValueError(f"want dists and labels of one [Q, L] shape, got "
                         f"{tuple(dists.shape)} and {tuple(labels.shape)}")
    if not (dists.is_contiguous() and labels.is_contiguous()):
        raise ValueError("dists and labels must be contiguous")
    if not 1 <= k <= dists.shape[1]:
        raise ValueError(f"k={k} must be in [1, L={dists.shape[1]}]")


def order_key(dists: torch.Tensor) -> torch.Tensor:
    """int32 key whose order is the IEEE total order of the float32
    ``dists``: a negative float's magnitude bits are flipped."""
    bits = dists.view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def topk_ref(dists: torch.Tensor, labels: torch.Tensor, k: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """dists [Q, L] f32, labels [Q, L] i32 -> (dists [Q, k], labels [Q, k])."""
    check_operands(dists, labels, k)
    _, idx = torch.sort(order_key(dists), dim=1, stable=True)
    idx = idx[:, :k]
    return torch.gather(dists, 1, idx), torch.gather(labels, 1, idx)
