"""Tiled attention with an online softmax: the hand-written CUDA kernels'
wrapper.

Replaces ``repro/kernels/flash_attention/flash_attention.py::
flash_attention_pallas`` with the semantics of its plain version
(``ref.mha_ref``): GQA, causal masking aligned at the ends, softmax in
float32, output in the input dtype. Unlike the Pallas wrapper it takes any
``Sq, Sk >= 1``: the ragged last tiles are masked in the kernel.

``csrc/flash_attention.cu`` holds two kernels, and :func:`route` picks one
from the dtype and ``dh`` alone (never from a value on the card):

  * ``"tensor_core"`` (bf16, ``dh % 16 == 0``, ``dh <= 256``; every LM
    path's prefill): 128-row q tiles, K/V tiles fed by TMA into a 2-stage
    shared-memory ring by a producer warpgroup, both products on wgmma with
    float32 accumulators. P is rounded to bf16 before ``P V`` (as
    ``scaled_dot_product_attention`` does); the row sum ``l`` is taken
    from the float32 P, before that rounding. ``ref.mha_p_bf16_ref`` is
    that arithmetic in plain PyTorch.
  * ``"simt"`` (float32, and bf16 with another ``dh``): 64-row tiles
    staged as float32, FMA on the CUDA cores, P not rounded; no TF32.

What bounds it on an H100: operations (``4 * Hq * dh * Sq * Sk`` flops,
about half that under causal masking at ``Sq == Sk``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_operand
from repro_torch.kernels.flash_attention.ref import check_operands

launches = 0            # kernel launches made by this wrapper, both routes
launches_tensor_core = 0
launches_simt = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_fns: dict = {}         # C entry point by route, bound once per process


def route(dtype: torch.dtype, dh: int) -> str:
    """The kernel that takes ``dtype`` at head width ``dh``:
    ``"tensor_core"`` for bf16 with ``dh % 16 == 0`` and ``dh <= 256``,
    else ``"simt"``."""
    if dtype == torch.bfloat16 and dh % 16 == 0 and dh <= 256:
        return "tensor_core"
    return "simt"


def _fn(which: str):
    fn = _fns.get(which)
    if fn is None:
        lib = _build.load("flash_attention")
        if which == "tensor_core":
            fn = lib.flash_attention_tc_launch
            fn.argtypes = [_P] * 4 + [_I] * 7 + [ctypes.c_float, _P]
        else:
            fn = lib.flash_attention_launch
            fn.argtypes = [_P] * 4 + [_I] * 7 + [ctypes.c_float, _I, _P]
        fn.restype = _I
        _fns[which] = fn
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, scale: float | None = None
                         ) -> torch.Tensor:
    """q [B,Hq,Sq,dh]; k, v [B,Hkv,Sk,dh], contiguous on one CUDA device,
    float32 or bfloat16 -> [B,Hq,Sq,dh] in q's dtype, through the kernel
    of :func:`route`. Launches on the current stream and raises if the
    launch is refused."""
    global launches, launches_tensor_core, launches_simt
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
    which = route(q.dtype, dh)
    if which == "tensor_core":        # TMA reads 16-byte aligned rows
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
    out = torch.empty_like(q)
    fn = _fn(which)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, hq, hkv, sq, sk, dh, int(causal), float(scale)]
        if which == "simt":
            args.append(int(q.dtype == torch.bfloat16))
        err = fn(*args, stream)
    if err:
        raise RuntimeError(f"flash_attention ({which}) launch failed: "
                           f"cudaError {err}")
    if b and hq:                      # the C side launches nothing for 0
        launches += 1
        if which == "tensor_core":
            launches_tensor_core += 1
        else:
            launches_simt += 1
    return out
