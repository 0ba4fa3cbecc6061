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

import struct

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



WARP_THREADS, WARP_UNROLL = 256, 2   # csrc/topk.cu's kWarpThreads, kUnroll


def _from_order_bits(b: int) -> float:
    """The float32 whose :func:`order_key` bits (offset to unsigned) are
    ``b``."""
    u = b & 0x7FFFFFFF if b & 0x80000000 else ~b & 0xFFFFFFFF
    return struct.unpack("<f", struct.pack("<I", u))[0]


class _WarpList:
    """One warp's list and threshold in the warp route (``WarpList``)."""

    def __init__(self, k: int):
        self.k, self.keys, self.buf = k, [], []
        self.limit, self.tf = 0xFFFFFFFF << 32, float("inf")

    def screen(self, keys: list[int]) -> None:
        """One ballot: the keys under the threshold go to the buffer; a
        buffer of 32 or more is merged."""
        self.buf += [key for key in keys if key < self.limit]
        if len(self.buf) >= 32:
            self.flush()

    def flush(self) -> None:
        self.keys = sorted(self.keys + self.buf)[:32]
        self.buf = []
        if len(self.keys) >= self.k:
            self.limit = self.keys[self.k - 1]
            self.tf = _from_order_bits(self.limit >> 32)


def topk_warp_ref(dists: torch.Tensor, labels: torch.Tensor, k: int,
                  misalign: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`topk_ref` by the warp route's steps (``csrc/topk.cu``,
    ``k <= 32``), in plain Python: row ``r`` starts ``misalign + r * L``
    floats past a 16-byte boundary; warp 0 screens the scalar head and
    tail, then each warp its float4 ``warp * 32 + lane + 256 * j``, two a
    lane a step, a float4 skipped unless a lane's smallest dist is ``<=``
    the k-th key's float, else each of its four dists screened as a key
    ``(order bits, column)`` against the k-th key; a buffer of 32 passing
    keys merges into the warp's 32 smallest, which sets the threshold;
    last the k smallest of the warps' lists. Equals :func:`topk_ref` bit
    for bit where the screens drop no key of the result."""
    check_operands(dists, labels, k)
    if k > 32:
        raise ValueError(f"the warp route takes k <= 32, got {k}")
    qn, n = dists.shape
    bits = (order_key(dists).long() + 2 ** 31).tolist()
    vals = dists.tolist()
    cols = torch.empty((qn, k), dtype=torch.long)
    for r in range(qn):
        key = [(b << 32) | c for c, b in enumerate(bits[r])]
        row = vals[r]
        a0 = min(n, (4 - (misalign + r * n)) % 4)
        n4 = (n - a0) // 4
        lists = []
        for w in range(WARP_THREADS // 32):
            wl = _WarpList(k)
            if w == 0:
                wl.screen(key[:a0] + key[a0 + 4 * n4:])
            for i0 in range(w * 32, n4, WARP_UNROLL * WARP_THREADS):
                for u in range(WARP_UNROLL):
                    i = i0 + u * WARP_THREADS
                    f4 = [a0 + 4 * j for j in range(i, min(i + 32, n4))]
                    if not any(min(row[c:c + 4]) <= wl.tf for c in f4):
                        continue
                    for e in range(4):
                        wl.screen([key[c + e] for c in f4])
            wl.flush()
            lists += wl.keys
        cols[r] = torch.tensor([x & 0xFFFFFFFF for x in sorted(lists)[:k]])
    return torch.gather(dists, 1, cols), torch.gather(labels, 1, cols)
