"""Unfused slab scan: the hand-written CUDA kernel's wrapper.

Replaces ``repro/kernels/sivf_scan/sivf_scan.py::sivf_scan_pallas``. The
kernel is ``csrc/sivf_scan.cu``: one warp per (query, table entry), lanes
over slots, the query row staged in shared memory once per block, and
the fused kernel's arithmetic (``csrc/dot_row.cuh``), so that the top-k
of its output (``kernels/topk``) equals ``sivf_fused_search`` bit for bit.
Its plain version is ``ref.sivf_scan_ref``.

What bounds it on an H100: bytes, above all the ``[Q, T*C]`` outputs
(8 bytes a slot, live or not); the design writes each once, coalesced.

Limits (checked, ``ValueError`` otherwise): ``C`` a multiple of 32; the
query row must fit the 48 KB of shared memory a block gets by default;
``Q * ceil(T / 8)`` blocks below 2**31.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sivf_scan.fused import raw_scan_operands

launches = 0            # kernel launches made by this wrapper

_MAX_SMEM = 48 * 1024
_WARPS = 8              # table entries per block (kWarps in the source)
_P = ctypes.c_void_p
_I = ctypes.c_int


def _fn():
    fn = _build.load("sivf_scan").sivf_scan_launch
    fn.argtypes = [_P] * 8 + [_I] * 6 + [_P]
    fn.restype = _I
    return fn


def sivf_scan_cuda(queries: torch.Tensor, table: torch.Tensor,
                   data: torch.Tensor, ids: torch.Tensor, norms: torch.Tensor,
                   bitmap: torch.Tensor, metric: str = "l2"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """queries [Q,D] f32, table [Q,T] i32 -> (dists [Q,T*C] f32, labels
    [Q,T*C] i32).

    data [n_slabs,C,D] f32, ids [n_slabs,C] i32, norms [n_slabs,C] f32,
    bitmap [n_slabs,C/32] i32, all contiguous on one CUDA device.
    Launches on the current stream and raises if the launch is refused.
    """
    global launches
    dev = queries.device
    qn, d_dim, _, c, words = raw_scan_operands(queries, table, data, ids,
                                               norms, bitmap, metric)
    t_len = table.shape[1]
    if 4 * ((d_dim + 3) // 4 * 4) > _MAX_SMEM:
        raise ValueError(f"D={d_dim} exceeds the kernel's {_MAX_SMEM} bytes "
                         "of shared memory")
    if qn * -(-t_len // _WARPS) >= 2 ** 31:
        raise ValueError(f"Q={qn}, T={t_len}: too many blocks for one launch")
    dists = torch.empty((qn, t_len * c), dtype=torch.float32, device=dev)
    labels = torch.empty((qn, t_len * c), dtype=torch.int32, device=dev)
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(queries.data_ptr(), table.data_ptr(), data.data_ptr(),
                 ids.data_ptr(), norms.data_ptr(), bitmap.data_ptr(),
                 dists.data_ptr(), labels.data_ptr(), qn, t_len, c, d_dim,
                 words, int(metric == "l2"), stream)
    if err:
        raise RuntimeError(f"sivf_scan launch failed: cudaError {err}")
    if qn and t_len:                  # the C side launches nothing for 0
        launches += 1
    return dists, labels
