"""Compiled filter programs: the fixed-shape predicate form the traversal runs.

Counterpart of `repro/filters/compile.py`. A `FilterProgram` holds, per
query, S padded clause slots and a DNF term table:

  kinds   [B, S]    i32   CLAUSE_CONTAIN | EQUAL | RANGE | IN
  masks   [B, S, W] i32   packed label mask (label clauses)
  lo/hi   [B, S]    f32   closed interval (range clauses)
  vattr   [B, S]    i32   numeric-attribute channel (range clauses)
  neg     [B, S]    bool  literal negation
  term    [B, S]    i32   owning DNF term
  active  [B, S]    bool  slot in use (padding slots are neutral)
  term_active [B, T] bool term in use

uint32 words: `repro` holds label words and masks as uint32. The port
holds the same bits as int32 (torch's uint32 has thin op coverage);
`&`, `==` and `!= 0` give the same answers on either view, and the host
arrays are reinterpreted with `np.ndarray.view(np.int32)`, never converted.

Lowering is host-side numpy, as in the reference: `compile_query` turns
one filter-algebra expression (`filters.expr`) into program rows in
canonical DNF order, `compile_filters` / `stack_programs` / `pad_program`
batch them, `compile_spec` lowers a `FilterSpec`; the leaves are the
reference's arrays (masks uint32) until `program_to` places them on a
device. `eval_program_matrix` evaluates a program against the whole
attribute store — the scan plan's candidate bitmap and the planner's exact
selectivities — in row chunks on the program's device.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.filters.expr import (
    CLAUSE_CONTAIN,
    CLAUSE_EQUAL,
    CLAUSE_IN,
    CLAUSE_RANGE,
    Expr,
    canonical_dnf,
    pack_mask,
)
from repro_torch.filters.predicates import (
    PRED_CONTAIN,
    PRED_EQUAL,
    PRED_RANGE,
    FilterSpec,
)

# Fixed number of clause slots tracked by the per-clause probe-selectivity
# counters (SearchState.n_clause_valid / the rho_clause_* features).
CLAUSE_FEATURE_SLOTS = 4

# Hard ceiling on compiled slots (the fused kernel keeps one bit per slot).
MAX_SLOTS = 32


class FilterProgram(NamedTuple):
    kinds: torch.Tensor        # [B, S] i32
    masks: torch.Tensor        # [B, S, W] i32 (uint32 bit patterns)
    lo: torch.Tensor           # [B, S] f32
    hi: torch.Tensor           # [B, S] f32
    vattr: torch.Tensor        # [B, S] i32
    neg: torch.Tensor          # [B, S] bool
    term: torch.Tensor         # [B, S] i32
    active: torch.Tensor       # [B, S] bool
    term_active: torch.Tensor  # [B, T] bool

    @property
    def batch(self) -> int:
        return int(self.kinds.shape[0])

    @property
    def n_slots(self) -> int:
        return int(self.kinds.shape[1])

    @property
    def n_terms(self) -> int:
        return int(self.term_active.shape[1])

    @property
    def n_words(self) -> int:
        return int(self.masks.shape[2])

    def slice(self, sl) -> "FilterProgram":
        """Rows `sl` (a slice or lane indices) of every leaf; numpy
        leaves stay numpy, tensors stay on their device."""
        def rows(a):
            if not isinstance(a, torch.Tensor):
                return np.asarray(a)[sl]
            if isinstance(sl, slice):
                return a[sl]
            return a.index_select(0, torch.as_tensor(
                np.asarray(sl), dtype=torch.long, device=a.device))
        return FilterProgram(*(rows(a) for a in self))


_LEAF_DTYPES = (torch.int32, torch.int32, torch.float32, torch.float32,
                torch.int32, torch.bool, torch.int32, torch.bool, torch.bool)


def _leaf_to_torch(a, dtype, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype).contiguous()
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)  # same bits; see the module docstring
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=dtype)


def program_to(prog, device) -> FilterProgram:
    """A program with numpy or torch leaves → torch leaves on `device`."""
    return FilterProgram(*(_leaf_to_torch(a, dt, device)
                           for a, dt in zip(prog, _LEAF_DTYPES)))


def _leaf_slot(leaf: Expr, n_words: int, n_values: int):
    """(kind, mask, lo, hi, vattr) arrays for one literal's leaf."""
    from repro_torch.filters.expr import Contain, Equal, In, Range

    if isinstance(leaf, Range):
        if leaf.attr >= n_values:
            raise ValueError(
                f"value channel {leaf.attr} outside [0,{n_values})")
        return (CLAUSE_RANGE, np.zeros(n_words, np.uint32),
                np.float32(leaf.lo), np.float32(leaf.hi), leaf.attr)
    kind = {Contain: CLAUSE_CONTAIN, Equal: CLAUSE_EQUAL,
            In: CLAUSE_IN}[type(leaf)]
    return (kind, pack_mask(leaf.labels, n_words), np.float32(0.0),
            np.float32(0.0), 0)


def compile_query(expr: Expr, n_words: int, n_values: int = 1,
                  ) -> FilterProgram:
    """One expression → program rows (numpy leaves, batch of 1), slots in
    canonical DNF order — the reference's arrays."""
    dnf = canonical_dnf(expr)
    n_slots = sum(len(t) for t in dnf)
    if n_slots > MAX_SLOTS:
        raise ValueError(f"filter compiles to {n_slots} clauses "
                         f"(max {MAX_SLOTS}); simplify the expression")
    s = max(1, n_slots)
    t = max(1, len(dnf))
    kinds = np.zeros((1, s), np.int32)
    masks = np.zeros((1, s, n_words), np.uint32)
    lo = np.zeros((1, s), np.float32)
    hi = np.zeros((1, s), np.float32)
    vattr = np.zeros((1, s), np.int32)
    neg = np.zeros((1, s), bool)
    term = np.zeros((1, s), np.int32)
    active = np.zeros((1, s), bool)
    term_active = np.zeros((1, t), bool)
    i = 0
    for ti, lits in enumerate(dnf):
        term_active[0, ti] = True
        for leaf, negated in lits:
            kinds[0, i], masks[0, i], lo[0, i], hi[0, i], vattr[0, i] = (
                _leaf_slot(leaf, n_words, n_values))
            neg[0, i] = negated
            term[0, i] = ti
            active[0, i] = True
            i += 1
    return FilterProgram(kinds, masks, lo, hi, vattr, neg, term, active,
                         term_active)


def pad_program(prog: FilterProgram, n_slots: int | None = None,
                n_terms: int | None = None, batch: int | None = None,
                ) -> FilterProgram:
    """Grow a program (numpy leaves) to (batch, n_slots, n_terms) with
    inert padding: inactive slots and terms, and rows with no active term,
    which match nothing."""
    b0, s0 = prog.kinds.shape
    t0 = prog.term_active.shape[1]
    s = s0 if n_slots is None else max(n_slots, s0)
    t = t0 if n_terms is None else max(n_terms, t0)
    b = b0 if batch is None else max(batch, b0)

    def grow(a, shape):
        a = np.asarray(a)
        out = np.zeros(shape, a.dtype)
        out[tuple(slice(0, d) for d in a.shape)] = a
        return out

    w = prog.masks.shape[2]
    return FilterProgram(
        kinds=grow(prog.kinds, (b, s)),
        masks=grow(prog.masks, (b, s, w)),
        lo=grow(prog.lo, (b, s)),
        hi=grow(prog.hi, (b, s)),
        vattr=grow(prog.vattr, (b, s)),
        neg=grow(prog.neg, (b, s)),
        term=grow(prog.term, (b, s)),
        active=grow(prog.active, (b, s)),
        term_active=grow(prog.term_active, (b, t)),
    )


def stack_programs(progs: Sequence[FilterProgram], n_slots: int | None = None,
                   n_terms: int | None = None, pad_to: int | None = None,
                   ) -> FilterProgram:
    """Stack per-query programs (batch 1 each, numpy leaves) into one
    padded batch; `pad_to` appends inert match-nothing rows."""
    s = max([p.kinds.shape[1] for p in progs] + [n_slots or 1])
    t = max([p.term_active.shape[1] for p in progs] + [n_terms or 1])
    rows = [pad_program(p, s, t) for p in progs]
    cat = FilterProgram(*(np.concatenate([np.asarray(r[i]) for r in rows])
                          for i in range(len(rows[0]))))
    if pad_to is not None and pad_to > cat.kinds.shape[0]:
        cat = pad_program(cat, batch=pad_to)
    return cat


def compile_filters(exprs: Sequence[Expr], n_words: int, n_values: int = 1,
                    n_slots: int | None = None, n_terms: int | None = None,
                    ) -> FilterProgram:
    """Compile a batch of (heterogeneous) expressions into one program."""
    return stack_programs([compile_query(e, n_words, n_values)
                           for e in exprs], n_slots, n_terms)


def compile_spec(spec: FilterSpec, n_words: int, n_values: int = 1,
                 ) -> FilterProgram:
    """Single-clause lowering of a `FilterSpec` batch (numpy leaves).

    Same arrays as `repro.filters.compile.compile_spec`.
    """
    del n_values  # a FilterSpec range reads channel 0
    b = spec.batch
    rng_kind = spec.kind == PRED_RANGE
    return FilterProgram(
        kinds=np.full((b, 1), _SPEC_KIND[spec.kind], np.int32),
        masks=(np.zeros((b, 1, n_words), np.uint32) if rng_kind
               else np.asarray(spec.label_masks, np.uint32)[:, None, :]),
        lo=(np.asarray(spec.range_lo, np.float32)[:, None] if rng_kind
            else np.zeros((b, 1), np.float32)),
        hi=(np.asarray(spec.range_hi, np.float32)[:, None] if rng_kind
            else np.zeros((b, 1), np.float32)),
        vattr=np.zeros((b, 1), np.int32),
        neg=np.zeros((b, 1), bool),
        term=np.zeros((b, 1), np.int32),
        active=np.ones((b, 1), bool),
        term_active=np.ones((b, 1), bool),
    )


def as_program(filt, n_words: int, n_values: int = 1) -> FilterProgram:
    """Accept a FilterProgram (any leaves), a FilterSpec, an Expr or a
    sequence of Exprs."""
    if isinstance(filt, FilterProgram):
        return filt
    if isinstance(filt, FilterSpec):
        return compile_spec(filt, n_words, n_values)
    if isinstance(filt, Expr):
        return compile_query(filt, n_words, n_values)
    return compile_filters(list(filt), n_words, n_values)


# ----------------------------------------------------------- evaluation ----
def eval_program_gathered(prog: FilterProgram, labels_g: torch.Tensor,
                          values_g: torch.Tensor):
    """Evaluate the program on gathered per-candidate attributes.

    labels_g [B, R, W] i32, values_g [B, R, V] f32 →
    (valid [B, R] bool, clause_sat [B, S, R] bool). All four primitives
    are evaluated for every slot and selected by kind tag, then combined
    through the term table, as in `repro`.
    """
    m = prog.masks[:, :, None, :]                       # [B,S,1,W]
    lg = labels_g[:, None, :, :]                        # [B,1,R,W]
    inter = lg & m
    c_contain = (inter == m).all(dim=-1)                # [B,S,R]
    c_equal = (lg == m).all(dim=-1)
    c_in = (inter != 0).any(dim=-1)
    b, s = prog.kinds.shape
    r, v = values_g.shape[1], values_g.shape[2]
    vat = prog.vattr.clamp(0, v - 1).long()
    vsel = torch.gather(values_g[:, None, :, :].expand(b, s, r, v), 3,
                        vat[:, :, None, None].expand(b, s, r, 1))[..., 0]
    c_range = (vsel >= prog.lo[:, :, None]) & (vsel <= prog.hi[:, :, None])

    k = prog.kinds[:, :, None]
    prim = torch.where(
        k == CLAUSE_CONTAIN, c_contain,
        torch.where(k == CLAUSE_EQUAL, c_equal,
                    torch.where(k == CLAUSE_RANGE, c_range, c_in)))
    act = prog.active[:, :, None]
    lit = prim ^ prog.neg[:, :, None]
    clause_sat = lit & act

    # a term fails iff any of its active literals fails; valid iff any
    # active term survives
    fail = (~lit) & act                                 # [B,S,R]
    t = prog.term_active.shape[1]
    member = ((prog.term[:, :, None]
               == torch.arange(t, device=prog.term.device,
                               dtype=prog.term.dtype))
              & prog.active[:, :, None])                # [B,S,T]
    term_fail = (member[:, :, :, None] & fail[:, :, None, :]).any(dim=1)
    term_ok = prog.term_active[:, :, None] & ~term_fail  # [B,T,R]
    return term_ok.any(dim=1), clause_sat


def _matrix_chunk(prog: FilterProgram, labels: torch.Tensor,
                  values: torch.Tensor):
    """One row chunk of the full-store evaluation: (valid [B, nb] bool,
    clause counts [B, CLAUSE_FEATURE_SLOTS] i32)."""
    b = prog.kinds.shape[0]
    nb = labels.shape[0]
    valid, csat = eval_program_gathered(
        prog, labels[None].expand(b, nb, labels.shape[1]),
        values[None].expand(b, nb, values.shape[1]))
    return valid, clause_counts(csat, torch.ones_like(valid))


# Rows per chunk of `eval_program_matrix`: the reference takes 2048 rows
# at a time; the card takes 65,536 (a [64, S, 65536, W] intermediate is
# tens of MB). Rows are evaluated independently, so the chunking cannot
# change the result.
MATRIX_CHUNK = 1 << 16


def eval_program_matrix(prog: FilterProgram, labels: torch.Tensor,
                        values: torch.Tensor, chunk: int = MATRIX_CHUNK):
    """Evaluate a program batch against the *full* attribute store.

    prog leaves [B, S, ...] on the store's device; labels [N, W] i32
    (uint32 bits); values [N, V] f32 → (valid [B, N] bool on that device,
    clause_frac [B, CLAUSE_FEATURE_SLOTS] f32 numpy). `valid.sum(1) / N`
    is σ_q exactly; `clause_frac` is each clause's satisfaction over the
    whole store. Boolean work only (0 NDC), and lane b's row depends only
    on its own program row. Same results as the reference's.
    """
    if values.dim() == 1:
        values = values[:, None]
    n = labels.shape[0]
    b = prog.kinds.shape[0]
    valid = torch.empty((b, n), dtype=torch.bool, device=labels.device)
    counts = torch.zeros((b, CLAUSE_FEATURE_SLOTS), dtype=torch.int64,
                         device=labels.device)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        v, cc = _matrix_chunk(prog, labels[s:e], values[s:e])
        valid[:, s:e] = v
        counts += cc
    frac = np.asarray(counts.cpu().numpy(), np.float32) / float(n)
    return valid, frac


def clause_counts(clause_sat: torch.Tensor, counted: torch.Tensor,
                  n_slots: int = CLAUSE_FEATURE_SLOTS) -> torch.Tensor:
    """Per-clause hit counters over the counted candidates.

    clause_sat [B, S, R] bool, counted [B, R] bool -> [B, n_slots] i32,
    truncating/zero-padding the program's S slots to the feature width.
    """
    cs = (clause_sat & counted[:, None, :]).sum(dim=-1).to(torch.int32)
    s = cs.shape[1]
    if s >= n_slots:
        return cs[:, :n_slots].contiguous()
    return torch.nn.functional.pad(cs, (0, n_slots - s))


# FilterSpec predicate tags → compiled clause kinds
_SPEC_KIND = {PRED_CONTAIN: CLAUSE_CONTAIN, PRED_EQUAL: CLAUSE_EQUAL,
              PRED_RANGE: CLAUSE_RANGE}
