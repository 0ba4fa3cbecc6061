"""The RWKV6 WKV recurrence: the hand-written CUDA kernel's wrapper.

Replaces ``repro/kernels/wkv6/wkv6.py::wkv6_pallas`` with the semantics
of its plain version (``ref.wkv6_ref``): the initial state comes in and
the final state goes out, so one kernel serves prefill (T = the prompt,
zero state) and decode (T = 1, the carried state), and any T >= 1 runs.
The kernel is ``csrc/wkv6.cu``: one block per (batch, head), one thread
per column of the ``[dk, dv]`` state, which it holds in registers; the
step's ``r``, ``k``, ``w`` rows and ``v`` are staged in shared memory 32
steps at a time.

What bounds it on an H100: bytes (r, k, v, w and y once, the two states
once). The function needs 5 flops per state element and step (2 for
r . S, 3 for S = w S + k v; the bonus term factors into a per-step
scalar times v), which at the fp32 peak take less time than the bytes.
Only B * H blocks run, so at B = 1 it is far from that bound.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_operand
from repro_torch.kernels.wkv6.ref import check_operands

launches = 0            # kernel launches made by this wrapper

DKS = (16, 32, 64, 128)  # head sizes the kernel is instantiated for
MAX_DV = 256             # one thread per state column
_P = ctypes.c_void_p
_I = ctypes.c_int


def _fn():
    fn = _build.load("wkv6").wkv6_launch
    fn.argtypes = [_P] * 8 + [_I] * 5 + [_P]
    fn.restype = _I
    return fn


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, w [B,T,H,dk]; v [B,T,H,dv]; u [H,dk]; s0 [B,H,dk,dv]; float32,
    contiguous on one CUDA device -> (y [B,T,H,dv], s_T [B,H,dk,dv]).
    Launches on the current stream and raises if the launch is refused."""
    global launches
    dev = r.device
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("s0", s0)):
        check_operand(name, x, dev, torch.float32)
    check_operands(r, k, v, w, u, s0)
    b, t, h, dk = r.shape
    dv = v.shape[-1]
    if dk not in DKS or not 1 <= dv <= MAX_DV:
        raise ValueError(f"dk={dk} must be one of {DKS} and dv={dv} lie in "
                         f"[1, {MAX_DV}]")
    y = torch.empty((b, t, h, dv), dtype=torch.float32, device=dev)
    s_out = torch.empty_like(s0)
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), s0.data_ptr(), y.data_ptr(), s_out.data_ptr(),
                 b, t, h, dk, dv, stream)
    if err:
        raise RuntimeError(f"wkv6 launch failed: cudaError {err}")
    if b and h:                       # the C side launches nothing for 0
        launches += 1
    return y, s_out
