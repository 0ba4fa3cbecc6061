"""Composable predicate algebra over named int attributes (filtered search).

The port's own copy of ``repro/core/filters.py`` (numpy only; the port
imports nothing of the JAX package). Same classes, the same structure
tuples and the same constant layout, so ``compile_filter`` gives ``==``
results on both sides.

  ``Eq(attr, v)``          attribute == v
  ``In(attr, (v0, ...))``  attribute in {v0, ...}
  ``Range(attr, lo, hi)``  lo <= attribute < hi   (half-open)
  ``And(p0, p1, ...)``     conjunction

``compile_filter`` splits a predicate into a hashable *structure* (which
attributes are tested, how, and how many constants each node consumes)
and a flat tuple of int32 *constants*. In the port the structure keys a
small per-structure cache of the CUDA kernels' flat leaf program
(:func:`leaf_program`); one compiled kernel serves every predicate, and
the constants ride as a kernel operand.

``eval_structure`` is the one evaluator of the plain versions, given two
accessors: ``get_attr(j) -> array`` (the j-th attribute column of the
candidate set, any shape) and ``get_const(i) -> scalar``. It builds the
plain scan's mask (torch) and the host-side numpy oracle
(``host_matches``).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np


@dataclasses.dataclass(frozen=True)
class Eq:
    """attribute == value."""

    attr: str
    value: int


@dataclasses.dataclass(frozen=True)
class In:
    """attribute ∈ values (non-empty)."""

    attr: str
    values: tuple[int, ...]

    def __post_init__(self):
        vals = tuple(int(v) for v in self.values)
        if not vals:
            raise ValueError("In() needs at least one value")
        object.__setattr__(self, "values", vals)


@dataclasses.dataclass(frozen=True)
class Range:
    """lo <= attribute < hi (half-open; empty ranges match nothing)."""

    attr: str
    lo: int
    hi: int


@dataclasses.dataclass(frozen=True, init=False)
class And:
    """Conjunction of sub-predicates."""

    preds: tuple

    def __init__(self, *preds):
        if not preds:
            raise ValueError("And() needs at least one predicate")
        object.__setattr__(self, "preds", tuple(preds))


Predicate = Eq | In | Range | And


@dataclasses.dataclass(frozen=True)
class CompiledFilter:
    """Hashable (structure, constants) split of a predicate.

    ``structure`` keys the kernels' leaf-program cache; ``consts`` ride
    as an int32 operand whose length is a function of the structure alone.
    """

    structure: tuple
    consts: tuple[int, ...]


def _attr_index(attr: str, attributes: tuple[str, ...]) -> int:
    if attr not in attributes:
        raise KeyError(
            f"unknown attribute {attr!r}; configured: {list(attributes)} "
            f"(set SIVFConfig(attributes=...))")
    return attributes.index(attr)


def _compile(pred, attributes: tuple[str, ...], consts: list) -> tuple:
    if isinstance(pred, Eq):
        consts.append(int(pred.value))
        return ("eq", _attr_index(pred.attr, attributes))
    if isinstance(pred, In):
        consts.extend(pred.values)
        return ("in", _attr_index(pred.attr, attributes), len(pred.values))
    if isinstance(pred, Range):
        consts.extend((int(pred.lo), int(pred.hi)))
        return ("range", _attr_index(pred.attr, attributes))
    if isinstance(pred, And):
        return ("and",
                *(_compile(p, attributes, consts) for p in pred.preds))
    raise TypeError(f"not a predicate: {pred!r}")


def compile_filter(pred: Predicate | None, attributes: tuple[str, ...]
                   ) -> CompiledFilter | None:
    """Predicate -> (structure, consts); None passes through."""
    if pred is None:
        return None
    consts: list[int] = []
    structure = _compile(pred, tuple(attributes), consts)
    return CompiledFilter(structure=structure, consts=tuple(consts))


def _eval(node: tuple, get_attr, get_const, base: int):
    tag = node[0]
    if tag == "eq":
        return get_attr(node[1]) == get_const(base), base + 1
    if tag == "range":
        a = get_attr(node[1])
        return (a >= get_const(base)) & (a < get_const(base + 1)), base + 2
    if tag == "in":
        a = get_attr(node[1])
        m = None
        for i in range(node[2]):
            e = a == get_const(base + i)
            m = e if m is None else (m | e)
        return m, base + node[2]
    if tag == "and":
        m = None
        for sub in node[1:]:
            sm, base = _eval(sub, get_attr, get_const, base)
            m = sm if m is None else (m & sm)
        return m, base
    raise ValueError(f"bad filter structure node {node!r}")


def eval_structure(structure: tuple, get_attr, get_const):
    """Evaluate a compiled structure to a boolean match mask.

    ``get_attr(j)`` returns the j-th attribute column over the candidate
    set (any array shape/backend); ``get_const(i)`` returns the i-th
    constant as a scalar of the same backend. The returned mask has the
    shape ``get_attr`` produces.
    """
    m, _ = _eval(structure, get_attr, get_const, 0)
    return m


LEAF_KINDS = {"eq": 0, "in": 1, "range": 2}


@functools.lru_cache(maxsize=None)
def leaf_program(structure: tuple) -> tuple[int, ...]:
    """A compiled structure as the CUDA kernels' flat leaf program.

    The algebra is closed under ``And`` only, so every structure is a
    conjunction of leaves. Returns ``(kind, attr, n_consts)`` int triples
    in the depth-first order in which ``eval_structure`` consumes the
    constants (``kind``: 0 eq, 1 in, 2 range), so leaf ``i``'s constants
    start at the sum of the earlier leaves' ``n_consts``.
    """
    tag = structure[0]
    if tag == "and":
        return tuple(v for sub in structure[1:] for v in leaf_program(sub))
    if tag == "eq":
        return (LEAF_KINDS["eq"], structure[1], 1)
    if tag == "in":
        return (LEAF_KINDS["in"], structure[1], structure[2])
    if tag == "range":
        return (LEAF_KINDS["range"], structure[1], 2)
    raise ValueError(f"bad filter structure node {structure!r}")


def host_matches(pred: Predicate, attributes: tuple[str, ...],
                 attrs) -> np.ndarray:
    """Numpy oracle: attrs [..., A] int -> bool mask [...].

    The brute-force-within-predicate reference used by tests and the
    ``filtered_sweep`` benchmark; same evaluator as the device masks.
    """
    cf = compile_filter(pred, tuple(attributes))
    a = np.asarray(attrs)
    return np.asarray(eval_structure(
        cf.structure,
        lambda j: a[..., j],
        lambda i: np.int32(cf.consts[i])))


def eq_bindings(pred: Predicate | None) -> dict[str, int]:
    """The attribute values a predicate pins exactly (Eq nodes, recursively
    through And). A serve layer uses this to force-stamp tenant attributes on
    ingest so a row can never escape its tenant's mandatory filter."""
    out: dict[str, int] = {}
    if isinstance(pred, Eq):
        out[pred.attr] = int(pred.value)
    elif isinstance(pred, And):
        for p in pred.preds:
            out.update(eq_bindings(p))
    return out


def normalize_attrs(attributes: tuple[str, ...], attrs, n: int,
                    overrides: dict[str, int] | None = None) -> np.ndarray:
    """Client attrs (dict of scalars/[n]-columns, or an [n, A] array) ->
    dense ``[n, A]`` int32, column order = ``attributes``.

    Every configured attribute must be covered (by ``attrs`` or
    ``overrides``) — silent zero-defaults would let rows slip out of a
    tenant's mandatory filter. ``overrides`` (serve-layer stamping) win
    over client-provided columns.
    """
    a = len(attributes)
    overrides = overrides or {}
    if attrs is None:
        attrs = {}
    if isinstance(attrs, dict):
        unknown = set(attrs) - set(attributes)
        if unknown:
            raise KeyError(f"unknown attributes {sorted(unknown)}; "
                           f"configured: {list(attributes)}")
        missing = [name for name in attributes
                   if name not in attrs and name not in overrides]
        if missing:
            raise ValueError(f"missing attributes {missing}: every "
                             "configured attribute must be stamped on add")
        out = np.zeros((n, a), np.int32)
        for j, name in enumerate(attributes):
            if name in overrides:
                out[:, j] = np.int32(overrides[name])
            else:
                out[:, j] = np.asarray(attrs[name], np.int32)
        return out
    arr = np.asarray(attrs, np.int32)
    if arr.shape != (n, a):
        raise ValueError(f"attrs shape {arr.shape} != {(n, a)} "
                         f"(attributes {list(attributes)})")
    if overrides:
        arr = arr.copy()
        for j, name in enumerate(attributes):
            if name in overrides:
                arr[:, j] = np.int32(overrides[name])
    return arr
