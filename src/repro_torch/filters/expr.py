"""Filter-expression algebra: composable boolean predicates over attributes.

Host-side copy of `repro/filters/expr.py` (numpy only), so the port needs
nothing of `repro`:

  leaves        Contain(labels)   L ⊆ A_i        (all listed labels present)
                Equal(labels)     L = A_i        (label set exactly equal)
                In(labels)        L ∩ A_i ≠ ∅    (at least one present)
                Range(lo, hi, attr)  value_attr[attr] ∈ [lo, hi]
  combinators   And(*), Or(*), Not(x)

Expressions are immutable and hashable. `canonical_dnf` rewrites any
expression into a sorted, deduplicated disjunctive normal form (negations
pushed to the leaves), which `filters.compile` lowers to a fixed-shape
`FilterProgram`; equivalent expressions give the same DNF, the same
program rows and the same `canonical_key` bytes as in the reference.

`eval_expr` is the naive recursive host oracle (numpy, no DNF, no
compilation) used by selectivity, the exact ground truth and the
compiled-program parity tests.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

# Clause (leaf) kind tags shared with the compiled program representation.
CLAUSE_CONTAIN = 0
CLAUSE_EQUAL = 1
CLAUSE_RANGE = 2
CLAUSE_IN = 3


class Expr:
    """Base class; combinator sugar so filters compose as `a & b | ~c`."""

    __slots__ = ()

    def __and__(self, other: "Expr") -> "And":
        return And(self, other)

    def __or__(self, other: "Expr") -> "Or":
        return Or(self, other)

    def __invert__(self) -> "Not":
        return Not(self)


def _label_tuple(labels: Iterable[int]) -> tuple[int, ...]:
    out = tuple(sorted({int(x) for x in labels}))
    if any(x < 0 for x in out):
        raise ValueError(f"labels must be non-negative, got {out}")
    return out


@dataclasses.dataclass(frozen=True)
class Contain(Expr):
    """All listed labels present: L ⊆ A_i. Contain(()) is vacuously true."""

    labels: tuple[int, ...]

    def __init__(self, labels: Iterable[int]):
        object.__setattr__(self, "labels", _label_tuple(labels))


@dataclasses.dataclass(frozen=True)
class Equal(Expr):
    """Label set exactly equal: A_i = L."""

    labels: tuple[int, ...]

    def __init__(self, labels: Iterable[int]):
        object.__setattr__(self, "labels", _label_tuple(labels))


@dataclasses.dataclass(frozen=True)
class In(Expr):
    """At least one listed label present: L ∩ A_i ≠ ∅. In(()) is false."""

    labels: tuple[int, ...]

    def __init__(self, labels: Iterable[int]):
        object.__setattr__(self, "labels", _label_tuple(labels))


@dataclasses.dataclass(frozen=True)
class Range(Expr):
    """Numeric attribute channel `attr` inside the closed interval [lo, hi]."""

    lo: float
    hi: float
    attr: int = 0

    def __init__(self, lo: float, hi: float, attr: int = 0):
        object.__setattr__(self, "lo", float(lo))
        object.__setattr__(self, "hi", float(hi))
        object.__setattr__(self, "attr", int(attr))


@dataclasses.dataclass(frozen=True)
class And(Expr):
    children: tuple[Expr, ...]

    def __init__(self, *children: Expr):
        object.__setattr__(self, "children", tuple(children))


@dataclasses.dataclass(frozen=True)
class Or(Expr):
    children: tuple[Expr, ...]

    def __init__(self, *children: Expr):
        object.__setattr__(self, "children", tuple(children))


@dataclasses.dataclass(frozen=True)
class Not(Expr):
    child: Expr

    def __init__(self, child: Expr):
        object.__setattr__(self, "child", child)


_LEAF_TYPES = (Contain, Equal, In, Range)

# A literal is (leaf, negated); a term is a tuple of literals combined by
# AND; a DNF is a tuple of terms combined by OR. The empty term is TRUE,
# the empty DNF is FALSE.
Literal = tuple[Expr, bool]
Term = tuple[Literal, ...]
Dnf = tuple[Term, ...]


def _leaf_key(leaf: Expr) -> tuple:
    """Total order on leaves — drives the canonical literal/term sort."""
    if isinstance(leaf, Contain):
        return (CLAUSE_CONTAIN, leaf.labels, 0.0, 0.0, 0)
    if isinstance(leaf, Equal):
        return (CLAUSE_EQUAL, leaf.labels, 0.0, 0.0, 0)
    if isinstance(leaf, In):
        return (CLAUSE_IN, leaf.labels, 0.0, 0.0, 0)
    if isinstance(leaf, Range):
        return (CLAUSE_RANGE, (), leaf.lo, leaf.hi, leaf.attr)
    raise TypeError(f"not a filter leaf: {leaf!r}")


def _lit_key(lit: Literal) -> tuple:
    leaf, neg = lit
    return _leaf_key(leaf) + (bool(neg),)


def _to_dnf(e: Expr, neg: bool) -> Dnf:
    """Push negation to the leaves (De Morgan) while distributing AND over
    OR. Returns terms-of-literals; no simplification yet."""
    if isinstance(e, Not):
        return _to_dnf(e.child, not neg)
    if isinstance(e, (And, Or)):
        conjunctive = isinstance(e, And) ^ neg  # ¬(a∧b) = ¬a ∨ ¬b
        parts = [_to_dnf(c, neg) for c in e.children]
        if not conjunctive:
            return tuple(t for p in parts for t in p)
        out: list[Term] = [()]
        for p in parts:
            out = [t1 + t2 for t1 in out for t2 in p]
            if len(out) > 4096:
                raise ValueError("DNF expansion exceeds 4096 terms; "
                                 "restructure the filter expression")
        return tuple(out)
    if isinstance(e, _LEAF_TYPES):
        return (((e, neg),),)
    raise TypeError(f"not a filter expression: {e!r}")


def canonical_dnf(e: Expr) -> Dnf:
    """Sorted, deduplicated DNF with negation pushed to the leaves.

    Commutative rewrites collapse (And(a,b) == And(b,a)); contradictory
    terms (x ∧ ¬x) are dropped; an always-true term collapses the whole
    DNF to the single empty term. The result is the *identity* of the
    filter for compilation and for serving-cache keys.
    """
    terms = []
    for term in _to_dnf(e, False):
        lits = sorted(set(term), key=_lit_key)
        if any((leaf, not neg) in lits for leaf, neg in lits):
            continue  # x AND NOT x — statically false term
        if not lits:
            return ((),)  # one TRUE term subsumes everything
        terms.append(tuple(lits))
    dedup = sorted(set(terms), key=lambda t: tuple(map(_lit_key, t)))
    return tuple(dedup)


def canonical_key(e: Expr) -> bytes:
    """Stable byte serialization of the canonical DNF (cache-key preimage).

    Floats serialize via their exact hex form, so two ranges differing in
    the last ulp never alias; structure bytes keep And/Or/Not distinctions
    that share the same leaf multiset distinct.
    """
    parts = [b"dnf["]
    for term in canonical_dnf(e):
        parts.append(b"term(")
        for leaf, neg in term:
            kind, labels, lo, hi, attr = _leaf_key(leaf)
            parts.append(b"%d|%d|%s|%s|%s|%d;" % (
                kind, int(neg), ",".join(map(str, labels)).encode(),
                float(lo).hex().encode(), float(hi).hex().encode(), attr))
        parts.append(b")")
    parts.append(b"]")
    return b"".join(parts)


# ------------------------------------------------------------- host oracle ----
def _values_2d(values: np.ndarray) -> np.ndarray:
    v = np.asarray(values)
    return v[:, None] if v.ndim == 1 else v


def pack_mask(labels, n_words: int) -> np.ndarray:
    """[W] uint32 multi-hot mask for a label tuple — the single packing
    implementation shared by the host oracle and the program compiler."""
    mask = np.zeros(n_words, np.uint32)
    for lab in labels:
        if lab >= 32 * n_words:
            raise ValueError(f"label {lab} outside packed alphabet "
                             f"[0,{32 * n_words})")
        mask[lab // 32] |= np.uint32(1) << np.uint32(lab % 32)
    return mask


def eval_leaf(leaf: Expr, labels_packed: np.ndarray, values: np.ndarray,
              ) -> np.ndarray:
    """[N] bool — one leaf over the whole corpus (numpy, host)."""
    if isinstance(leaf, Range):
        v = _values_2d(values)[:, leaf.attr]
        return (v >= np.float32(leaf.lo)) & (v <= np.float32(leaf.hi))
    mask = pack_mask(leaf.labels, labels_packed.shape[-1])
    if isinstance(leaf, Contain):
        return ((labels_packed & mask) == mask).all(axis=-1)
    if isinstance(leaf, Equal):
        return (labels_packed == mask).all(axis=-1)
    if isinstance(leaf, In):
        return ((labels_packed & mask) != 0).any(axis=-1)
    raise TypeError(f"not a filter leaf: {leaf!r}")


def eval_expr(e: Expr, labels_packed: np.ndarray, values: np.ndarray,
              ) -> np.ndarray:
    """[N] bool — naive recursive evaluation (the parity/recall oracle).

    Deliberately structured nothing like the compiled path: no NNF, no DNF,
    no padding — plain recursive descent over the original expression.
    """
    if isinstance(e, And):
        out = np.ones(labels_packed.shape[0], bool)
        for c in e.children:
            out &= eval_expr(c, labels_packed, values)
        return out
    if isinstance(e, Or):
        out = np.zeros(labels_packed.shape[0], bool)
        for c in e.children:
            out |= eval_expr(c, labels_packed, values)
        return out
    if isinstance(e, Not):
        return ~eval_expr(e.child, labels_packed, values)
    return eval_leaf(e, labels_packed, values)


def labels_from_mask(mask: np.ndarray) -> tuple[int, ...]:
    """Unpack a [W] uint32 multi-hot mask back into a sorted label tuple."""
    mask = np.asarray(mask, np.uint32).reshape(-1)
    out = []
    for w, word in enumerate(mask):
        word = int(word)
        while word:
            low = word & -word
            out.append(32 * w + low.bit_length() - 1)
            word ^= low
    return tuple(out)
