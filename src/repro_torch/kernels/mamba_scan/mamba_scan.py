"""The Mamba selective scan: the hand-written CUDA kernel's wrapper.

Replaces ``repro/kernels/mamba_scan/mamba_scan.py::mamba_scan_pallas``
with the semantics of its plain version (``ref.mamba_scan_ref``): the
initial state comes in and the final state goes out, so one kernel serves
prefill (T = the prompt, zero state) and decode (T = 1, the carried
state); any T >= 1, any ``di`` (the Pallas wrapper asserts ``di %
block_d == 0``) and any ``n <= 64`` run. The kernel is
``csrc/mamba_scan.cu``: a channel's ``n`` state elements split over
``lanes`` threads of ``elems`` each (registers), a block a group of
channels; ``u``, ``delta``, ``b`` and ``c`` staged with 16-byte
``cp.async``, double-buffered; the exponentials of four steps computed
ahead of their chain; each lane's partial of ``y`` summed per staged
chunk in shared memory. ``ref.mamba_scan_split_ref`` is that order of
operations in plain PyTorch.

The launch plan (:func:`launch_plan`) comes from shapes alone: the
wrapper reads no tensor value on the host.

What bounds it on an H100: the ``T * di * n`` exponentials at the SFU
rate and, about as much, bytes (u, delta, y and the two states once).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_operand
from repro_torch.kernels.mamba_scan.ref import check_operands

launches = 0            # kernel launches made by this wrapper

MAX_N = 64               # state width the kernel takes
ELEMS = 4                # state elements a thread holds, at most (csrc E)
THREADS = 128            # threads a block (csrc kThreads)
MAX_CHUNK = 32           # time steps staged per pass, at most
_P = ctypes.c_void_p
_I = ctypes.c_int
_FN = []                 # the C entry point, bound once per process


def _fn():
    if not _FN:
        fn = _build.load("mamba_scan").mamba_scan_launch
        fn.argtypes = [_P] * 9 + [_I] * 8 + [_P]
        fn.restype = _I
        _FN.append(fn)
    return _FN[0]


def _pow2(x: int) -> int:
    return 1 << (x - 1).bit_length()


def smem_bytes(threads: int, lanes: int, elems: int, chunk: int) -> int:
    """Dynamic shared memory of one block (``csrc/mamba_scan.cu``
    ``smem_floats``): u and delta ``[2][2][chunk][channels]``, b and c
    ``[2][2][chunk][lanes * elems]``, the lanes' partials of y
    ``[chunk][threads]`` and d, float32."""
    cpb = threads // lanes
    return 4 * (4 * chunk * (cpb + lanes * elems) + chunk * threads + cpb)


def launch_plan(u: torch.Tensor, delta: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
                h0: torch.Tensor) -> dict:
    """The launch's split of the state (elements a thread, threads a
    channel, channels a block), chunk, grid and shared memory, from the
    operands' shapes alone (it reads no tensor value: meta tensors will
    do). Raises for ``n`` outside ``[1, MAX_N]``."""
    bsz, t, di = u.shape
    return dict(_plan(bsz, t, di, a.shape[1]))


@functools.lru_cache(maxsize=64)
def _plan(bsz: int, t: int, di: int, n: int) -> dict:
    if not 1 <= n <= MAX_N:
        raise ValueError(f"n={n} must lie in [1, {MAX_N}]")
    elems = min(ELEMS, _pow2(n))
    lanes = _pow2(-(-n // elems))
    chunk = min(MAX_CHUNK, _pow2(t))
    cpb = THREADS // lanes
    return {"elems": elems, "lanes": lanes, "threads": THREADS,
            "channels": cpb, "grid": (-(-di // cpb), bsz), "chunk": chunk,
            "smem_bytes": smem_bytes(THREADS, lanes, elems, chunk),
            "vec": di % 4 == 0 and n % 4 == 0}


def mamba_scan_cuda(u: torch.Tensor, delta: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
                    h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """u, delta [B,T,di]; a [di,n]; b, c [B,T,n]; d [di]; h0 [B,di,n];
    float32, contiguous on one CUDA device -> (y [B,T,di], h_T [B,di,n]).
    Launches on the current stream and raises if the launch is refused."""
    global launches
    dev = u.device
    ops = (u, delta, a, b, c, d, h0)
    for name, x in zip(("u", "delta", "a", "b", "c", "d", "h0"), ops):
        check_operand(name, x, dev, torch.float32)
    check_operands(*ops)
    bsz, t, di = u.shape
    n = a.shape[1]
    plan = _plan(bsz, t, di, n)
    if bsz >= 65536:
        raise ValueError(f"B={bsz} must be below 65536 (grid y)")
    vec = plan["vec"] and all(x.data_ptr() % 16 == 0 for x in ops)
    y = torch.empty_like(u)
    h_out = torch.empty_like(h0)
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(u.data_ptr(), delta.data_ptr(), a.data_ptr(), b.data_ptr(),
                 c.data_ptr(), d.data_ptr(), h0.data_ptr(), y.data_ptr(),
                 h_out.data_ptr(), bsz, t, di, n, plan["elems"],
                 plan["lanes"], plan["chunk"], int(vec), stream)
    if err:
        raise RuntimeError(f"mamba_scan launch failed: cudaError {err}")
    if bsz and di:                    # the C side launches nothing for 0
        launches += 1
    return y, h_out
