"""Tiled attention with an online softmax: the hand-written CUDA kernel's
wrapper.

Replaces ``repro/kernels/flash_attention/flash_attention.py::
flash_attention_pallas`` with the semantics of its plain version
(``ref.mha_ref``): GQA, causal masking aligned at the ends, float32
products and softmax, output in the input dtype. The kernel is
``csrc/flash_attention.cu``: one block per (64-row q tile, batch * q
head), k/v tiles of 64 rows staged in shared memory as float32, FMA on
the CUDA cores; under causal masking the tiles above the diagonal band
are skipped. Unlike the Pallas wrapper it takes any ``Sq, Sk >= 1``: the
ragged last tiles are masked in the kernel.

What bounds it on an H100: operations (``4 * Hq * dh * Sq * Sk`` flops,
about half that under causal masking at ``Sq == Sk``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_operand
from repro_torch.kernels.flash_attention.ref import check_operands

launches = 0            # kernel launches made by this wrapper

_P = ctypes.c_void_p
_I = ctypes.c_int


def _fn():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = [_P] * 4 + [_I] * 7 + [ctypes.c_float, _I, _P]
    fn.restype = _I
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, scale: float | None = None
                         ) -> torch.Tensor:
    """q [B,Hq,Sq,dh]; k, v [B,Hkv,Sk,dh], contiguous on one CUDA device,
    float32 or bfloat16 -> [B,Hq,Sq,dh] in q's dtype. Launches on the
    current stream and raises if the launch is refused."""
    global launches
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_operand(name, t, dev)
    check_operands(q, k, v)
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if dh % 4 or not 4 <= dh <= 256:
        raise ValueError(f"head_dim {dh} must be a multiple of 4 in [4, 256]")
    if b * hq >= 65536:
        raise ValueError(f"B*Hq={b * hq} must be below 65536 (grid y)")
    scale = dh ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, hq, hkv, sq, sk, dh, int(causal), float(scale),
                 int(q.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    if b and hq:                      # the C side launches nothing for 0
        launches += 1
    return out
