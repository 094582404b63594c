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

Lowering filter-algebra expressions (`compile_query`, `expr.py`) waits
for a later slice; `compile_spec` lowers a `FilterSpec`, and programs
compiled by `repro` carry across as arrays (see `repro_torch.convert`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.filters.predicates import (
    PRED_CONTAIN,
    PRED_EQUAL,
    PRED_RANGE,
    FilterSpec,
)

CLAUSE_CONTAIN = 0
CLAUSE_EQUAL = 1
CLAUSE_RANGE = 2
CLAUSE_IN = 3

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
    """Accept a FilterProgram (any leaves) or a FilterSpec."""
    if isinstance(filt, FilterProgram):
        return filt
    if isinstance(filt, FilterSpec):
        return compile_spec(filt, n_words, n_values)
    raise TypeError(
        f"expected a FilterSpec or FilterProgram, got {type(filt).__name__}; "
        "filter-algebra expressions are not ported yet — compile them with "
        "the reference compiler and carry the arrays across")


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
