from repro_torch.filters.predicates import (
    PRED_CONTAIN,
    PRED_EQUAL,
    PRED_RANGE,
    FilterSpec,
    filter_matrix,
    pack_labels,
    selectivity,
)
from repro_torch.filters.compile import (
    CLAUSE_FEATURE_SLOTS,
    FilterProgram,
    as_program,
    clause_counts,
    compile_spec,
    eval_program_gathered,
    program_to,
)

__all__ = [
    "PRED_CONTAIN",
    "PRED_EQUAL",
    "PRED_RANGE",
    "FilterSpec",
    "filter_matrix",
    "pack_labels",
    "selectivity",
    "CLAUSE_FEATURE_SLOTS",
    "FilterProgram",
    "as_program",
    "clause_counts",
    "compile_spec",
    "eval_program_gathered",
    "program_to",
]
