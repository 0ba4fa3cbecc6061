"""The operand check every kernel wrapper makes before it launches."""
from __future__ import annotations

import torch


def check_operand(name: str, t: torch.Tensor, device: torch.device,
                  dtype: torch.dtype | None = None,
                  ndim: int | None = None) -> None:
    """Raise unless ``t`` is contiguous on the CUDA ``device`` and, where
    given, of ``dtype`` with ``ndim`` dims."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}; "
                         "the CPU path is the kernel's ref.py")
    if t.device != device:
        raise ValueError("all operands must be on one device")
    if (dtype is not None and t.dtype != dtype) \
            or (ndim is not None and t.dim() != ndim) \
            or not t.is_contiguous():
        want = " ".join(w for w in ("contiguous", dtype and str(dtype),
                                    ndim and f"{ndim}-d") if w)
        raise ValueError(f"{name}: want a {want} tensor, got {t.dtype} "
                         f"{tuple(t.shape)}")
