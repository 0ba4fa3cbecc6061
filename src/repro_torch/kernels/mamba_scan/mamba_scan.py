"""The Mamba selective scan: the hand-written CUDA kernel's wrapper.

Replaces ``repro/kernels/mamba_scan/mamba_scan.py::mamba_scan_pallas``
with the semantics of its plain version (``ref.mamba_scan_ref``): the
initial state comes in and the final state goes out, so one kernel serves
prefill (T = the prompt, zero state) and decode (T = 1, the carried
state); any T >= 1, any ``di`` (the Pallas wrapper asserts ``di %
block_d == 0``) and any ``n <= 64`` run. The kernel is
``csrc/mamba_scan.cu``: one thread per (batch row, channel) holding its
``h[n]`` in registers, ``b_t`` and ``c_t`` staged in shared memory 32
steps at a time.

What bounds it on an H100: bytes (u, delta, y and the two states once)
and, about as much, the ``T * di * n`` exponentials at the SFU rate.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_operand
from repro_torch.kernels.mamba_scan.ref import check_operands

launches = 0            # kernel launches made by this wrapper

MAX_N = 64               # state width the kernel is instantiated up to
_P = ctypes.c_void_p
_I = ctypes.c_int


def _fn():
    fn = _build.load("mamba_scan").mamba_scan_launch
    fn.argtypes = [_P] * 9 + [_I] * 4 + [_P]
    fn.restype = _I
    return fn


def mamba_scan_cuda(u: torch.Tensor, delta: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
                    h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """u, delta [B,T,di]; a [di,n]; b, c [B,T,n]; d [di]; h0 [B,di,n];
    float32, contiguous on one CUDA device -> (y [B,T,di], h_T [B,di,n]).
    Launches on the current stream and raises if the launch is refused."""
    global launches
    dev = u.device
    for name, x in (("u", u), ("delta", delta), ("a", a), ("b", b),
                    ("c", c), ("d", d), ("h0", h0)):
        check_operand(name, x, dev, torch.float32)
    check_operands(u, delta, a, b, c, d, h0)
    bsz, t, di = u.shape
    n = a.shape[1]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"n={n} must lie in [1, {MAX_N}]")
    if bsz >= 65536:
        raise ValueError(f"B={bsz} must be below 65536 (grid y)")
    y = torch.empty_like(u)
    h_out = torch.empty_like(h0)
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(u.data_ptr(), delta.data_ptr(), a.data_ptr(), b.data_ptr(),
                 c.data_ptr(), d.data_ptr(), h0.data_ptr(), y.data_ptr(),
                 h_out.data_ptr(), bsz, t, di, n, stream)
    if err:
        raise RuntimeError(f"mamba_scan launch failed: cudaError {err}")
    if bsz and di:                    # the C side launches nothing for 0
        launches += 1
    return y, h_out
