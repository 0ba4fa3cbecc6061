"""The kernels' ``meta`` route: what a kernel call on ``meta`` tensors
leaves behind.

Each kernel's ``ops`` entry point takes this route only for ``meta``
tensors (a CUDA tensor still launches the kernel or raises, a CPU tensor
takes the plain version): it returns empty outputs of the kernel's
shapes and dtypes and reports the call's work, from the same formula
``chip_smoke.py`` bounds the kernel with, to every sink entered with
:func:`recording` (``launch.op_count`` counts with one). No launch count
moves. A plain recurrence on ``meta`` tensors would loop once per token;
the route costs one call. Under autograd (a train step counted on
``meta``) the route's outputs carry gradients (:func:`outputs`).
"""
from __future__ import annotations

import contextlib

import torch

_sinks: list = []


def record(name: str, flops: int, bytes_: int) -> None:
    """One kernel call's work, to every active sink."""
    for sink in _sinks:
        sink(name, int(flops), int(bytes_))


@contextlib.contextmanager
def recording(sink):
    """While entered, ``sink(name, flops, bytes)`` hears every kernel call
    on the ``meta`` route."""
    _sinks.append(sink)
    try:
        yield
    finally:
        _sinks.remove(sink)


class _Route(torch.autograd.Function):
    """Empty outputs; the backward records twice the forward's work (the
    plain recurrence's backward, which no kernel runs, counted by the
    forward's formula) and returns empty gradients."""

    @staticmethod
    def forward(ctx, name, flops, bytes_, like, *inputs):
        ctx.work = (name, flops, bytes_)
        ctx.shapes = [(x.shape, x.dtype) for x in inputs]
        return tuple(t.new_empty(t.shape) for t in like)

    @staticmethod
    def backward(ctx, *grads):
        name, flops, bytes_ = ctx.work
        record(name + ".backward", 2 * flops, 2 * bytes_)
        return (None, None, None, None) + tuple(
            torch.empty(s, dtype=d, device="meta") for s, d in ctx.shapes)


def outputs(name: str, flops: int, bytes_: int, inputs: tuple,
            like: tuple) -> tuple:
    """Record one call's work and return empty tensors shaped as ``like``;
    where an input requires a gradient (a train step counted on ``meta``)
    the outputs carry one through :class:`_Route`."""
    record(name, flops, bytes_)
    if torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
        return _Route.apply(name, flops, bytes_, like, *inputs)
    return tuple(t.new_empty(t.shape) for t in like)
