"""The RWKV6 WKV recurrence: the hand-written CUDA kernel's wrapper.

Replaces ``repro/kernels/wkv6/wkv6.py::wkv6_pallas`` with the semantics
of its plain version (``ref.wkv6_ref``): the initial state comes in and
the final state goes out, so one kernel serves prefill (T = the prompt,
zero state) and decode (T = 1, the carried state), and any T >= 1 runs.
The kernel is ``csrc/wkv6.cu``: one block per (batch, head, group of 32
state columns), each thread a 4 x 4 block of the state held in registers
(4 rows, a slice, by 4 columns); each step a thread updates its 16
elements and writes its slice's partial of ``y``, and after each staged
chunk of steps the block sums the slices and adds the factored bonus
``beta_t v`` (``beta_t = sum_i r_i u_i k_i``). ``r``, ``k``, ``w`` and
``v`` are staged with 16-byte ``cp.async``, double-buffered; the T = 1
instance is compiled for more resident blocks. ``ref.wkv6_split_ref`` is
that order of operations in plain PyTorch.

The launch plan (:func:`launch_plan`) comes from shapes alone: the
wrapper reads no tensor value on the host.

What bounds it on an H100: bytes (r, k, v, w and y once, the two states
once). The function needs 5 flops per state element and step (2 for
r . S, 3 for S = w S + k v), which at the fp32 peak take less time than
the bytes.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_operand
from repro_torch.kernels.wkv6.ref import check_operands

launches = 0            # kernel launches made by this wrapper

DKS = (16, 32, 64, 128)  # head sizes the kernel is instantiated for
ROWS = 4                 # state rows a thread holds (csrc kRows)
QUAD = 4                 # state columns a thread holds (csrc kQuad)
COLS = 32                # state columns a block holds (csrc kCols)
MAX_CHUNK = 32           # time steps staged per pass, at most
SMEM_LIMIT = 232448      # an H100 block's dynamic shared memory
_P = ctypes.c_void_p
_I = ctypes.c_int
_FN = []                 # the C entry point, bound once per process


def _fn():
    if not _FN:
        fn = _build.load("wkv6").wkv6_launch
        fn.argtypes = [_P] * 8 + [_I] * 7 + [_P]
        fn.restype = _I
        _FN.append(fn)
    return _FN[0]


def smem_bytes(dk: int, chunk: int) -> int:
    """Dynamic shared memory of one block (``csrc/wkv6.cu``
    ``smem_floats``): r, k, w double-buffered ``[2][3][chunk][dk]``, v
    ``[2][chunk][COLS]``, the slices' partials ``[chunk][dk / ROWS][COLS]``,
    u and beta, float32."""
    return 4 * (2 * chunk * (3 * dk + COLS) + dk + chunk
                + chunk * (dk // ROWS) * COLS)


def launch_plan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor) -> dict:
    """The launch's slices, column groups, chunk, grid and shared memory,
    from the operands' shapes alone (it reads no tensor value: meta
    tensors will do). Raises for a head size the kernel is not built
    for."""
    b, t, h, dk = r.shape
    return dict(_plan(b, t, h, dk, v.shape[-1]))


@functools.lru_cache(maxsize=64)
def _plan(b: int, t: int, h: int, dk: int, dv: int) -> dict:
    if dk not in DKS or dv < 1:
        raise ValueError(f"dk={dk} must be one of {DKS} and dv={dv} >= 1")
    chunk = min(MAX_CHUNK, 1 << (t - 1).bit_length())
    while smem_bytes(dk, chunk) > SMEM_LIMIT:
        chunk //= 2
    groups = -(-dv // COLS)
    return {"rows": ROWS, "slices": dk // ROWS,
            "threads": dk // ROWS * COLS // QUAD,
            "cols": COLS, "col_groups": groups, "blocks": b * h * groups,
            "chunk": chunk, "smem_bytes": smem_bytes(dk, chunk),
            "vec": dv % 4 == 0, "decode_instance": t == 1}


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, w [B,T,H,dk]; v [B,T,H,dv]; u [H,dk]; s0 [B,H,dk,dv]; float32,
    contiguous on one CUDA device -> (y [B,T,H,dv], s_T [B,H,dk,dv]).
    Launches on the current stream and raises if the launch is refused."""
    global launches
    dev = r.device
    ops = (r, k, v, w, u, s0)
    for name, x in zip(("r", "k", "v", "w", "u", "s0"), ops):
        check_operand(name, x, dev, torch.float32)
    check_operands(*ops)
    b, t, h, dk = r.shape
    dv = v.shape[-1]
    plan = _plan(b, t, h, dk, dv)
    vec = plan["vec"] and all(x.data_ptr() % 16 == 0 for x in ops)
    y = torch.empty((b, t, h, dv), dtype=torch.float32, device=dev)
    s_out = torch.empty_like(s0)
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), s0.data_ptr(), y.data_ptr(), s_out.data_ptr(),
                 b, t, h, dk, dv, plan["chunk"], int(vec), stream)
    if err:
        raise RuntimeError(f"wkv6 launch failed: cudaError {err}")
    if b and h:                       # the C side launches nothing for 0
        launches += 1
    return y, s_out
