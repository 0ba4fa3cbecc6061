"""One-token decode attention over a paged KV cache: the hand-written
CUDA kernel's wrapper.

Replaces ``repro/kernels/paged_attention/paged_attention.py::
paged_attention_pallas`` with the semantics of its plain version
(``ref.paged_attention_ref``). The kernel is ``csrc/paged_attention.cu``,
split over the window (flash-decoding) in two passes: one block per
(split, KV head, sequence) takes its share of the sequence's window (the
window cut on the card into ``n_split`` equal parts of whole 32-slot
chunks), serves the KV head's ``g`` query heads from one read of each
live row (chunks copied to shared memory with 16-byte ``cp.async``, two
in flight) and writes a partial ``(m, l, acc)``; a second small kernel
merges the partials. ``ref.paged_attention_split_ref`` is that
arithmetic in plain PyTorch.

The launch plan (:func:`launch_plan`) comes from shapes and dtypes only:
the wrapper never reads ``lengths``, ``starts`` or the tables on the
host, so a call adds no host sync. A split whose share of the window is
empty writes an empty partial and exits on the card.

What bounds it on an H100: bytes, each live K/V row of the window read
once (``sum(length - start) * Hkv * (dk + dv)`` elements). The partials
(``B * Hq * n_split * (2 + dv)`` float32) are the kernel's own traffic.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_operand
from repro_torch.kernels.paged_attention.ref import check_operands

launches = 0            # calls that launched the kernel (both passes)

MAX_SPLITS = 32         # blocks of the first pass per (sequence, KV head)
CHUNK = 32              # slots per step inside a block (csrc kChunk)
SMEM_LIMIT = 232448     # an H100 block's dynamic shared memory
_P = ctypes.c_void_p
_I = ctypes.c_int
_FN = []                # the C entry point, bound once per process


def _fn():
    if not _FN:
        fn = _build.load("paged_attention").paged_attention_launch
        fn.argtypes = [_P] * 9 + [_I] * 11 + [ctypes.c_float, _I, _P]
        fn.restype = _I
        _FN.append(fn)
    return _FN[0]


def split_plan(maxp: int, page: int,
               max_splits: int = MAX_SPLITS) -> tuple[int, int]:
    """``(split, n_split)`` for block tables of ``maxp`` pages of
    ``page`` slots: ``n_split`` blocks per (sequence, KV head), one per
    32-slot chunk of the table up to ``max_splits``, and ``split`` the
    most slots one block's share of a window can hold (whole chunks)."""
    slots = maxp * page
    n_split = max(1, min(max_splits, -(-slots // CHUNK)))
    share = -(-slots // n_split)
    return max(CHUNK, -(-share // CHUNK) * CHUNK), n_split


def smem_bytes(g: int, dk: int, dv: int, elem: int, split: int, page: int,
               stages: int) -> int:
    """Dynamic shared memory of one first-pass block
    (``csrc/paged_attention.cu`` ``layout``): the K and V rings (rows
    padded to whole 16-byte vectors plus one), q and the running sums in
    float32, the chunk's scores, (m, l, alpha) and the split's page ids."""
    def a16(x):
        return -(-x // 16) * 16
    ve = 16 // elem
    ldk, ldv = -(-dk // ve) * ve + ve, -(-dv // ve) * ve + ve
    return (a16(stages * CHUNK * ldk * elem) + a16(stages * CHUNK * ldv * elem)
            + a16(g * dk * 4) + a16(g * dv * 4) + a16(g * CHUNK * 4)
            + a16(g * 12) + a16(((split - 1) // page + 2) * 4))


def launch_plan(q: torch.Tensor, k_pages: torch.Tensor,
                v_pages: torch.Tensor, block_tables: torch.Tensor) -> dict:
    """The launch's split, ring depth, load width, shared memory and
    scratch shapes, from the operands' shapes and dtype alone (it reads no
    tensor value: meta tensors will do). Raises where no ring fits."""
    b, hq, dk = q.shape
    _, page, hkv, _ = k_pages.shape
    return dict(_plan(b, hq, dk, page, hkv, v_pages.shape[-1],
                      block_tables.shape[1], q.element_size()))


@functools.lru_cache(maxsize=64)
def _plan(b: int, hq: int, dk: int, page: int, hkv: int, dv: int, maxp: int,
          elem: int) -> dict:
    split, n_split = split_plan(maxp, page, MAX_SPLITS)
    for stages in (2, 1):
        smem = smem_bytes(hq // hkv, dk, dv, elem, split, page, stages)
        if smem <= SMEM_LIMIT:
            break
    else:
        raise ValueError(f"Hq/Hkv={hq // hkv} with dk={dk}, dv={dv} needs "
                         "more shared memory than a block has")
    return {"split": split, "n_split": n_split, "stages": stages,
            "vec": (dk * elem) % 16 == 0 and (dv * elem) % 16 == 0,
            "smem_bytes": smem, "ml_shape": (b, hq, n_split, 2),
            "acc_shape": (b, hq, n_split, dv),
            "scratch_bytes": 4 * b * hq * n_split * (2 + dv)}


def paged_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, block_tables: torch.Tensor,
                         lengths: torch.Tensor, starts: torch.Tensor,
                         scale: float | None = None) -> torch.Tensor:
    """q [B,Hq,dk]; pages [P,page,Hkv,dk|dv]; int32 tables [B,maxp],
    lengths and starts [B]; all contiguous on one CUDA device -> [B,Hq,dv]
    in q's dtype. Launches both passes on the current stream and raises if
    a launch is refused."""
    global launches
    dev = q.device
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("lengths", lengths),
                    ("starts", starts)):
        check_operand(name, t, dev)
    check_operands(q, k_pages, v_pages, block_tables, lengths, starts)
    b, hq, dk = q.shape
    n_pages, page, hkv, _ = k_pages.shape
    dv = v_pages.shape[-1]
    maxp = block_tables.shape[1]
    if not (1 <= dk <= 512 and 1 <= dv <= 512):
        raise ValueError(f"dk={dk}, dv={dv} must lie in [1, 512]")
    if maxp * page >= 2 ** 30:
        raise ValueError("maxp * page must fit 30 bits")
    plan = _plan(b, hq, dk, page, hkv, dv, maxp, q.element_size())
    vec = plan["vec"] and k_pages.data_ptr() % 16 == 0 \
        and v_pages.data_ptr() % 16 == 0
    scale = dk ** -0.5 if scale is None else scale
    out = torch.empty((b, hq, dv), dtype=q.dtype, device=dev)
    scratch = torch.empty(plan["scratch_bytes"] // 4, dtype=torch.float32,
                          device=dev)        # (m, l) partials, then sums
    ml_size = b * hq * plan["n_split"] * 2
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 block_tables.data_ptr(), lengths.data_ptr(),
                 starts.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                 scratch[ml_size:].data_ptr(), b, hq, hkv, dk, dv, page, maxp,
                 plan["split"], plan["n_split"], plan["stages"], int(vec),
                 float(scale), int(q.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"paged_attention launch failed: cudaError {err}")
    if b and hq:                      # the C side launches nothing for 0
        launches += 1
    return out
