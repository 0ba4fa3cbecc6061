"""Public entry point of the top-k selection, dispatched by device.

Counterpart of ``repro/kernels/topk/ops.py::topk``. A CPU tensor takes
the plain version (``ref.topk_ref``); a CUDA tensor launches the
hand-written kernel (``topk.topk_cuda``) or raises. There is no fallback
from the card to the plain version. The launch count lives on the
kernel's wrapper (``topk.launches``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.topk import topk as kernel
from repro_torch.kernels.topk.ref import topk_ref


def topk(dists: torch.Tensor, labels: torch.Tensor, k: int
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k by distance: dists/labels [Q, L] -> [Q, k] each, in
    ascending order, the lower column first on equal distances."""
    if dists.device.type == "cpu":
        return topk_ref(dists, labels, k)
    return kernel.topk_cuda(dists, labels, k)
