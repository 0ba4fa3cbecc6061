"""Fused ADC scan -> top-k over PQ codes: the hand-written CUDA kernel's
wrapper.

Replaces ``repro/kernels/sivf_scan/pq_fused.py::sivf_pq_fused_search_pallas``,
unfiltered and filtered. The kernel is ``csrc/sivf_pq_fused_search.cu``:
one thread block per query, one thread per slab slot; the block stages
its query's ``[m, ksub]`` ADC table in shared memory and each thread sums
its slot's ``m`` lookups in ascending subspace order, then the block folds
the candidates as ``sivf_fused_search`` does (``csrc/topk_fold.cuh``).
Filtered searches take the same leaf program and constants as
``fused.py``. Its plain version is ``ref.sivf_pq_fused_search_ref``; fed
the same ADC table the two agree bit for bit.

What bounds it on an H100: bytes, and at Q=1024, m=32, ksub=256 the ADC
tables themselves (``Q*m*ksub*4``, read once per query) are the largest
term, ahead of the ``m + 4`` bytes per live probed slot.

Limits (checked, ``ValueError`` otherwise): ``C`` a multiple of 32 up to
1024; ``1 <= k <= 1024``; the table, ``4k`` top-k entries and ``C``
candidates must fit the 227 KB of shared memory a block may use (the
launcher raises the block's limit above 48 KB).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_operand
from repro_torch.kernels.sivf_scan.fused import filter_operands

launches = 0            # unfiltered kernel launches made by this wrapper
filtered_launches = 0   # filtered kernel launches made by this wrapper

MAX_SMEM = 227 * 1024
_P = ctypes.c_void_p
_I = ctypes.c_int


def _fn():
    lib = _build.load("sivf_pq_fused_search")
    fn = lib.sivf_pq_fused_search_launch
    fn.argtypes = [_P] * 7 + [_I, _P, _I, _P, _P] + [_I] * 7 + [_P]
    fn.restype = _I
    return fn


def smem_bytes(m: int, ksub: int, c: int, k: int) -> int:
    """Shared memory one block uses: the table, 4k top-k entries, C
    candidates (``sivf_pq_fused_search_smem_bytes`` in the source)."""
    return 4 * (m * ksub + 4 * k + c)


def sivf_pq_fused_search_cuda(adc: torch.Tensor, table: torch.Tensor,
                              codes: torch.Tensor, ids: torch.Tensor,
                              bitmap: torch.Tensor, k: int,
                              attrs: torch.Tensor | None = None,
                              fstruct: tuple | None = None,
                              fconsts: torch.Tensor | None = None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """adc [Q,m,ksub] f32, table [Q,T] i32 -> (dists [Q,k] f32, labels [Q,k]).

    codes [n_slabs,C,m] uint8, ids [n_slabs,C] i32, bitmap [n_slabs,C/32]
    i32, all contiguous on one CUDA device. With ``fstruct``, ``attrs``
    [n_slabs,C,A] i32 and ``fconsts`` [n_consts] i32 select the filtered
    kernel. Launches on the current stream and raises if the launch (or
    the shared-memory limit it needs) is refused.
    """
    global launches, filtered_launches
    dev = adc.device
    for name, t, dt, nd in (("adc", adc, torch.float32, 3),
                            ("table", table, torch.int32, 2),
                            ("codes", codes, torch.uint8, 3),
                            ("ids", ids, torch.int32, 2),
                            ("bitmap", bitmap, torch.int32, 2)):
        check_operand(name, t, dev, dt, nd)
    qn, m, ksub = adc.shape
    n_slabs, c, _ = codes.shape
    words = c // 32
    if c % 32 or not 32 <= c <= 1024:
        raise ValueError(f"slab capacity C={c} must be a multiple of 32 in "
                         "[32, 1024]")
    if not 1 <= k <= 1024:
        raise ValueError(f"k={k} must be in [1, 1024]")
    if table.shape[0] != qn or codes.shape[2] != m \
            or tuple(ids.shape) != (n_slabs, c) \
            or tuple(bitmap.shape) != (n_slabs, words):
        raise ValueError("inconsistent operand shapes")
    if smem_bytes(m, ksub, c, k) > MAX_SMEM:
        raise ValueError(f"m={m}, ksub={ksub}, k={k}, C={c} exceed the "
                         f"kernel's {MAX_SMEM} bytes of shared memory")
    a_ptr, prog, n_leaves, consts, n_attrs, _keep = filter_operands(
        attrs, fstruct, fconsts, n_slabs, c, dev)
    dists = torch.empty((qn, k), dtype=torch.float32, device=dev)
    labels = torch.empty((qn, k), dtype=torch.int32, device=dev)
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(adc.data_ptr(), table.data_ptr(), codes.data_ptr(),
                 ids.data_ptr(), bitmap.data_ptr(), a_ptr, prog, n_leaves,
                 consts, n_attrs, dists.data_ptr(), labels.data_ptr(), qn,
                 table.shape[1], c, m, ksub, words, k, stream)
    if err:
        raise RuntimeError(
            f"sivf_pq_fused_search launch failed: cudaError {err}")
    if fstruct is None:
        launches += 1
    else:
        filtered_launches += 1
    return dists, labels
