"""Small shared utilities (PyTorch counterpart of ``repro/utils.py``)."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; ``"cuda"`` needs a visible GPU.

    Entry points default to ``device="cuda"``. On a machine without one this
    raises instead of quietly running on the CPU: the CPU is used only when
    the caller asks for it (``device="cpu"``, as the tests do).
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the port on the CPU")
    return dev


def ceil_div(a, b):
    """Ceiling division for ints or int tensors."""
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    """Round ``a`` up to the next multiple of ``b``."""
    return int(ceil_div(a, b) * b)


def exclusive_cumsum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Exclusive prefix sum along ``dim`` (same dtype as ``x``)."""
    return torch.cumsum(x, dim=dim, dtype=x.dtype) - x


def l2_sq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise squared L2 distance, ``a [..., N,D]`` x ``b [..., M,D]`` ->
    ``[..., N,M]`` (leading dims batch).

    Keeps the ||a||^2 - 2 a.b + ||b||^2 expansion of the reference so the
    inner term is one matrix product (full fp32: callers keep TF32 off).
    """
    aa = torch.sum(a * a, dim=-1, keepdim=True)                    # [..,N,1]
    bb = torch.sum(b * b, dim=-1, keepdim=True).transpose(-1, -2)  # [..,1,M]
    return aa - 2.0 * (a @ b.transpose(-1, -2)) + bb
