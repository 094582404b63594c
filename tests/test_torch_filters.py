"""Filter algebra and program compilation of the PyTorch port, held to the
JAX reference on CPU.

The port keeps its own copy of the numpy-only expression module and of the
lowering (`compile_query`, `pad_program`, `stack_programs`,
`compile_filters`, `as_program`); both packages must produce the same
program arrays, canonical keys and oracle masks from the same expressions.
`eval_program_matrix` (the scan plan's bitmap, on the device) must give
the reference's valid bitmap, counts and clause fractions, whatever the
row chunking. `make_composite_workload` must draw the same queries,
expressions and selectivities from the same seed.
"""
import numpy as np
import pytest
import torch

import repro.filters as J
from repro.data import make_composite_workload as j_composite
from repro.data import make_dataset as j_make_dataset
from repro.filters.compile import eval_program_matrix as j_matrix
import repro_torch.filters as P
from repro_torch.data import make_composite_workload, make_dataset
from repro_torch.filters.compile import eval_program_matrix, program_to

STRUCTURES = ["and", "or", "not", "mixed"]


def _random_exprs(pkg, rng, b, n_values=2):
    """Random expressions built from `pkg` (repro.filters or
    repro_torch.filters) with the same draws for both packages."""

    def leaf():
        c = int(rng.integers(0, 4))
        labs = rng.integers(0, 40, int(rng.integers(1, 3))).tolist()
        if c == 0:
            return pkg.Contain(labs)
        if c == 1:
            return pkg.Equal(labs)
        if c == 2:
            return pkg.In(labs)
        lo = float(rng.random())
        return pkg.Range(lo, lo + 0.3, attr=int(rng.integers(0, n_values)))

    def expr(depth):
        if depth == 0:
            return leaf()
        c = int(rng.integers(0, 4))
        if c == 0:
            return pkg.And(expr(depth - 1), expr(depth - 1))
        if c == 1:
            return pkg.Or(expr(depth - 1), expr(depth - 1))
        if c == 2:
            return pkg.Not(expr(depth - 1))
        return leaf()

    return [expr(int(rng.integers(0, 3))) for _ in range(b)]


def _both_exprs(seed, b=12):
    return (_random_exprs(J, np.random.default_rng(seed), b),
            _random_exprs(P, np.random.default_rng(seed), b))


def _assert_programs_equal(got, want):
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=name)
        assert np.asarray(g).dtype == np.asarray(w).dtype, name


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_canonical_dnf_and_keys_match_reference(seed):
    jex, pex = _both_exprs(seed)
    for je, pe in zip(jex, pex):
        assert P.canonical_key(pe) == J.canonical_key(je)
    assert P.canonical_key(P.And(P.Contain([1]), P.Range(0, 1))) == \
        P.canonical_key(P.And(P.Range(0, 1), P.Contain([1])))


@pytest.mark.parametrize("seed", [0, 1])
def test_compile_query_and_stack_match_reference(seed):
    """compile_query per expression, compile_filters / stack_programs
    over the batch (with inert rows from pad_to), and as_program over an
    Expr, a list and a FilterSpec."""
    from repro.filters.compile import (compile_filters as j_cf,
                                       compile_query as j_cq,
                                       stack_programs as j_stack)

    jex, pex = _both_exprs(seed)
    for je, pe in zip(jex, pex):
        _assert_programs_equal(P.compile_query(pe, 2, 2), j_cq(je, 2, 2))
    _assert_programs_equal(P.compile_filters(pex, 2, 2), j_cf(jex, 2, 2))
    _assert_programs_equal(
        P.stack_programs([P.compile_query(e, 2, 2) for e in pex],
                         n_slots=6, n_terms=3, pad_to=16),
        j_stack([j_cq(e, 2, 2) for e in jex], n_slots=6, n_terms=3,
                pad_to=16))
    _assert_programs_equal(P.as_program(pex[0], 2, 2),
                           J.as_program(jex[0], 2, 2))
    _assert_programs_equal(P.as_program(pex, 2, 2), J.as_program(jex, 2, 2))
    masks = np.random.default_rng(seed).integers(0, 1 << 20, (4, 2)).astype(
        np.uint32)
    pspec = P.FilterSpec(P.PRED_CONTAIN, masks)
    _assert_programs_equal(P.as_program(pspec.to_expr(), 2),
                           P.as_program(pspec, 2))


def test_compile_query_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError, match="value channel"):
        P.compile_query(P.Range(0, 1, attr=3), 2, 2)
    wide = P.And(*[P.Contain([i]) for i in range(33)])
    with pytest.raises(ValueError, match="clauses"):
        P.compile_query(wide, 2, 2)


@pytest.fixture(scope="module")
def data():
    kw = dict(n=1500, dim=8, n_clusters=5, alphabet_size=40, seed=3)
    return j_make_dataset(**kw), make_dataset(**kw)


@pytest.mark.parametrize("chunk", [None, 128, 1000])
def test_eval_program_matrix_matches_reference(data, chunk):
    """The [B, N] bitmap, its counts and the clause fractions, equal to the
    reference's and to the recursive oracle, for any row chunking."""
    jds, ds = data
    jex, pex = _both_exprs(7, b=10)
    jprog = J.compile_filters(jex, jds.n_words, 2)
    want_valid, want_frac = j_matrix(
        type(jprog)(*(np.asarray(a) for a in jprog)), jds.labels_packed,
        jds.value_matrix)
    prog = program_to(P.compile_filters(pex, ds.n_words, 2), "cpu")
    labels = torch.from_numpy(ds.labels_packed.view(np.int32))
    values = torch.from_numpy(ds.value_matrix)
    kw = {} if chunk is None else {"chunk": chunk}
    valid, frac = eval_program_matrix(prog, labels, values, **kw)
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    np.testing.assert_array_equal(frac, want_frac)
    assert frac.dtype == np.float32
    np.testing.assert_array_equal(
        valid.numpy(), P.filter_matrix(pex, ds.labels_packed,
                                       ds.value_matrix))
    assert valid.any(axis=1).any() and (~valid).any()


def test_oracle_and_selectivity_match_reference(data):
    jds, ds = data
    jex, pex = _both_exprs(9, b=8)
    np.testing.assert_array_equal(
        P.filter_matrix(pex, ds.labels_packed, ds.value_matrix),
        J.filter_matrix(jex, jds.labels_packed, jds.value_matrix))
    np.testing.assert_array_equal(
        P.selectivity(pex, ds.labels_packed, ds.value_matrix, chunk=3),
        J.selectivity(jex, jds.labels_packed, jds.value_matrix))
    for je, pe in zip(jex, pex):
        np.testing.assert_array_equal(
            P.eval_expr(pe, ds.labels_packed, ds.value_matrix),
            J.eval_expr(je, jds.labels_packed, jds.value_matrix))
    m = np.array([0b1011, 1 << 31], np.uint32)
    assert P.labels_from_mask(m) == J.labels_from_mask(m)


@pytest.mark.parametrize("structure", STRUCTURES)
def test_composite_workload_matches_reference(data, structure):
    """Queries, hardness and σ bit for bit, and expressions with equal
    canonical keys and equal compiled programs."""
    jds, ds = data
    kw = dict(batch=24, structure=structure, seed=4,
              selectivities=(0.05, 0.10, 0.20), hard_fraction=0.5)
    jwl, wl = j_composite(jds, **kw), make_composite_workload(ds, **kw)
    for name in ("queries", "sigma_global", "hardness"):
        np.testing.assert_array_equal(getattr(wl, name), getattr(jwl, name))
    assert wl.spec is None and wl.filters is wl.exprs
    assert [P.canonical_key(e) for e in wl.exprs] == \
        [J.canonical_key(e) for e in jwl.exprs]
    _assert_programs_equal(P.compile_filters(wl.filter_slice(3, 9),
                                             ds.n_words, 2),
                           J.compile_filters(jwl.filter_slice(3, 9),
                                             jds.n_words, 2))
