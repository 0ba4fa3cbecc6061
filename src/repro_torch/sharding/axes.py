"""Logical-axis sharding: the port's counterpart of
``repro/sharding/axes.py``.

Model code names each parameter dim by a *logical* axis ("embed",
"heads", "kv_heads", "mlp", "vocab", "expert", ...). A rules table, built
per (arch, mesh, shape) by ``sharding.rules.make_plan``, maps logical
names to mesh axes. A spec here is a plain tuple with one entry per dim:
a mesh axis name, a tuple of names, or ``None``. It equals the
reference's ``PartitionSpec`` read as a tuple (``tuple(P(None, "model"))
== (None, "model")``; no rules give ``()``, as ``P()`` does).

The reference records axes with ``annot`` on each leaf of its param tree.
The port's parameters are a ``DecoderLM`` module, so each model module
keeps its groups' axes in a table beside its init function (``AXES`` in
``models/common.py``, ``attention.py``, ``mlp.py``, ``rwkv.py``,
``mamba.py``) and :func:`logical_axes` reads a module's parameters
through them: a layer's parameters carry the reference's axes without its
leading period-stack ``None`` (the port keeps one module per layer).

``constrain`` is not ported as a call: the port has no GSPMD to steer.
The layouts it asks for are what the model mesh places
(``models/parallel.py``).
"""
from __future__ import annotations

import contextlib
import threading

_state = threading.local()


def current_rules() -> dict | None:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_rules(rules: dict | None):
    """Activate a logical -> mesh rules table for :func:`spec_for` calls
    that pass no table."""
    prev = current_rules()
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def spec_for(ax: tuple, rules: dict | None = None) -> tuple:
    """Logical axes -> spec under ``rules`` (default: the active table);
    ``()`` without rules."""
    rules = current_rules() if rules is None else rules
    if rules is None:
        return ()
    return tuple(rules.get(a) if a is not None else None for a in ax)


def specs_tree(axes: dict, rules: dict | None = None) -> dict:
    """``{name: logical axes}`` -> ``{name: spec}``."""
    return {n: spec_for(a, rules) for n, a in axes.items()}


def group_axes(path: tuple) -> dict:
    """The axes table of the parameter group at ``path`` (its names in a
    ``DecoderLM``, e.g. ``("layers", "3", "attn")`` or ``("embed",)``)."""
    from repro_torch.models import attention, common, mamba, mlp, rwkv
    tables = {**common.AXES, **attention.AXES, **mlp.AXES, **rwkv.AXES,
              **mamba.AXES}
    group = path[-1]
    if group == "shared":                 # the MoE's shared experts
        group = "mlp"
    return tables[group]


def logical_axes(params) -> dict:
    """``{name: logical axes}`` of every parameter of a ``DecoderLM`` (or
    any module of its groups), in ``named_parameters`` order. Raises
    ``KeyError`` for a parameter no table names and ``ValueError`` where
    a table's rank differs from the tensor's."""
    out = {}
    for name, p in params.named_parameters():
        *path, leaf = name.split(".")
        ax = group_axes(tuple(path))[leaf]
        if len(ax) != p.dim():
            raise ValueError(f"{name}: axes {ax} for shape "
                             f"{tuple(p.shape)}")
        out[name] = ax
    return out
