"""Kernel parity of the PyTorch port against the JAX reference, on CPU.

The plain PyTorch versions of K1 (`fused_step_plain`; K3 and K4 are its
int8 and PQ heads), K2 (`gbdt_predict_plain`), K6 (`sqdist_masked_plain`;
its row-id variant `sqdist_rows_plain`) and K7 (`topm_merge_plain`) take
the same numpy-made inputs as the reference's host path / interpret-mode
kernels and `kernels/ref.py` oracles. The CUDA kernels themselves are held
against the plain versions by the `cuda`-marked tests (and by
chip_smoke.py on the card), tie cases included. K5's plain version has
its own file, tests/test_torch_persistent.py. The merge by rank that
K1/K3/K4 and K5 share has no CPU mode: a torch transcription of its rank
formulas is held to `merge_stable` here, under heavy ties; so are K7's
(`_topm_by_rank`), and K2's walk and tree-order sum (`_gbdt_tree_order`)
are held bit for bit to a float32 tree-by-tree sum.

Tolerances: ids, payloads, masks and counts must be equal; float32
distances agree to rtol/atol 1e-5 (the two packages sum in different
orders) and exactly on grid data, where every sum is exact; GBDT
predictions to rtol 1e-5 (leaf sums in different orders), and bit for bit
where both sum in tree order.
"""
import functools

import numpy as np
import pytest
import torch

from _hyp_compat import given, settings, st  # hypothesis or fallback
from repro_torch.convert import gbdt_from_arrays, program_to_torch
from repro_torch.core.gbdt import train_gbdt
from repro_torch.filters.compile import FilterProgram
from repro_torch.kernels import _build
from repro_torch.kernels import ops
from repro_torch.kernels.distance import (SCAN_ALIGN, sqdist_bdrd,
                                          sqdist_masked, sqdist_masked_plain,
                                          sqdist_rows, sqdist_rows_plain)
from repro_torch.kernels.fused_step import fused_step, fused_step_plain
from repro_torch.kernels.gbdt import gbdt_predict, gbdt_predict_plain
from repro_torch.kernels.topk import (pack_payload, topm_merge,
                                      topm_merge_plain, unpack_payload)

# The reference (JAX) is imported inside the parity tests, so that the
# `cuda`-marked tests also run on a machine without JAX:
#     python -m pytest -m cuda tests/test_torch_kernels.py

NAMES = ("cand_dist", "cand_pay", "res_dist", "res_idx", "valid", "clause_add")
INF = float("inf")


def _program(rng, b, n_words, n_values, max_slots=3, max_terms=2):
    """Random multi-slot programs compiled by the reference (numpy leaves)."""
    from repro.filters.compile import compile_filters
    from repro.filters.expr import And, Contain, In, Not, Or, Range

    def leaf():
        c = rng.integers(0, 4)
        if c == 0:
            return Contain(rng.integers(0, 32 * n_words, rng.integers(1, 3)))
        if c == 1:
            return In(rng.integers(0, 32 * n_words, rng.integers(1, 3)))
        lo = float(rng.random())
        return Range(lo, lo + float(rng.random()) * 0.5,
                     attr=int(rng.integers(0, n_values)))

    def expr():
        leaves = [leaf() for _ in range(int(rng.integers(1, max_slots + 1)))]
        leaves = [Not(x) if rng.random() < 0.3 else x for x in leaves]
        return And(*leaves) if rng.random() < 0.5 else Or(*leaves)

    return compile_filters([expr() for _ in range(b)], n_words, n_values,
                           n_terms=max_terms)


def _numpy_program(rng, b, n_words, n_values, s=4, t=2):
    """Random program arrays without the reference compiler: every slot
    kind, negation and term assignment, one active term at least."""
    return FilterProgram(
        kinds=rng.integers(0, 4, (b, s)).astype(np.int32),
        masks=rng.integers(0, 1 << 32, (b, s, n_words), dtype=np.uint32),
        lo=(rng.random((b, s)) * 0.5).astype(np.float32),
        hi=(0.5 + rng.random((b, s)) * 0.5).astype(np.float32),
        vattr=rng.integers(0, n_values, (b, s)).astype(np.int32),
        neg=rng.random((b, s)) < 0.3,
        term=rng.integers(0, t, (b, s)).astype(np.int32),
        active=rng.random((b, s)) < 0.8,
        term_active=np.ones((b, t), bool))


def _inputs(rng, b, m, r, k, d, integer=False, compiled=True):
    """numpy inputs of one step; integer=True makes every distance an exact
    small integer, so ties are frequent and bit-equal in both packages.
    compiled=False draws the program without the reference compiler."""
    w, v = 2, 2
    if integer:
        q = rng.integers(-2, 3, (b, d)).astype(np.float32)
        x = rng.integers(-2, 3, (b, r, d)).astype(np.float32)
        x[:, 1] = x[:, 0]
    else:
        q = rng.normal(size=(b, d)).astype(np.float32)
        x = rng.normal(size=(b, r, d)).astype(np.float32)
    nb = rng.integers(0, 1 << 20, (b, r)).astype(np.int32)
    nb[:, -1] = nb[:, 0]
    is_new = rng.random((b, r)) < 0.8
    prog = (_program if compiled else _numpy_program)(rng, b, w, v)
    labels = rng.integers(0, 1 << 32, (b, r, w), dtype=np.uint32)
    values = rng.random((b, r, v)).astype(np.float32)
    if integer:
        cd = np.sort(rng.integers(0, 4 * d, (b, m)).astype(np.float32), axis=1)
        rd = np.sort(rng.integers(0, 4 * d, (b, k)).astype(np.float32), axis=1)
    else:
        cd = np.sort(rng.random((b, m)).astype(np.float32) * 50, axis=1)
        rd = np.sort(rng.random((b, k)).astype(np.float32) * 50, axis=1)
    cd[:, m // 2:] = np.inf
    rd[:, k // 2:] = np.inf
    cp = rng.integers(0, 1 << 20, (b, m)).astype(np.int32)
    cp[np.isinf(cd)] = -1
    ri = rng.integers(0, 1 << 20, (b, k)).astype(np.int32)
    ri[np.isinf(rd)] = -1
    return q, x, nb, is_new, prog, labels, values, cd, cp, rd, ri


def _jax_args(a):
    import jax.numpy as jnp
    from repro.filters.compile import FilterProgram as JProgram

    q, x, nb, is_new, prog, labels, values, cd, cp, rd, ri = a
    return (jnp.asarray(q), jnp.asarray(x), jnp.asarray(nb),
            jnp.asarray(is_new), JProgram(*(jnp.asarray(t) for t in prog)),
            jnp.asarray(labels), jnp.asarray(values), jnp.asarray(cd),
            jnp.asarray(cp), jnp.asarray(rd), jnp.asarray(ri))


def _torch_args(a, device="cpu"):
    q, x, nb, is_new, prog, labels, values, cd, cp, rd, ri = a
    t = lambda z: torch.from_numpy(np.ascontiguousarray(z)).to(device)  # noqa: E731
    return (t(q), t(x), t(nb), t(is_new), program_to_torch(prog, device),
            t(labels.view(np.int32)), t(values), t(cd), t(cp), t(rd), t(ri))


def _assert_step_equal(got, want, exact_dist=False):
    for g, w_, name in zip(got, want, NAMES):
        g, w_ = np.asarray(g), np.asarray(w_)
        if w_.dtype == np.float32:
            finite = np.isfinite(w_)
            assert np.array_equal(np.isinf(g), ~finite), name
            if exact_dist:
                np.testing.assert_array_equal(g[finite], w_[finite], name)
            else:
                np.testing.assert_allclose(g[finite], w_[finite], rtol=1e-5,
                                           atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w_.astype(g.dtype), err_msg=name)


@pytest.mark.parametrize("b,m,r,k,d", [(4, 32, 8, 5, 12), (8, 128, 32, 10, 24),
                                       (3, 64, 17, 7, 33)])
@pytest.mark.parametrize("pre", [False, True])
def test_fused_step_plain_matches_reference(b, m, r, k, d, pre):
    """fused_step_plain == the reference host path and its ref oracle."""
    from repro.kernels import ref

    rng = np.random.default_rng(b * 100 + m + r)
    a = _inputs(rng, b, m, r, k, d)
    got = [t.numpy() for t in fused_step_plain(*_torch_args(a), pre=pre)]
    _assert_step_equal(got, _fused_step_host()(*_jax_args(a), pre=pre))
    _assert_step_equal(got, ref.fused_step_ref(*_jax_args(a), pre=pre))
    # the CPU wrapper is the plain version
    got2 = [t.numpy() for t in fused_step(*_torch_args(a), pre=pre)]
    _assert_step_equal(got2, got, exact_dist=True)


@pytest.mark.parametrize("pre", [False, True])
def test_fused_step_plain_tie_order_matches_host(pre):
    """Exact distance ties (old vs new, new vs new, repeated ids) merge in
    the reference host path's stable order."""
    rng = np.random.default_rng(7)
    b, m, r, k, d = 6, 32, 16, 6, 8
    a = _inputs(rng, b, m, r, k, d, integer=True)
    got = [t.numpy() for t in fused_step_plain(*_torch_args(a), pre=pre)]
    want = _fused_step_host()(*_jax_args(a), pre=pre)
    _assert_step_equal(got, want, exact_dist=True)
    cd = got[0]
    assert (np.diff(cd[:, : m // 2], axis=1) == 0).any(), "no ties exercised"


@pytest.mark.cuda
@pytest.mark.parametrize("pre", [False, True])
def test_fused_step_kernel_matches_plain_on_cuda(pre):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel K1 has no CPU mode)")
    rng = np.random.default_rng(11)
    for integer in (True, False):
        a = _torch_args(_inputs(rng, 16, 128, 32, 10, 64, integer,
                                compiled=False), "cuda")
        got = [t.cpu().numpy() for t in fused_step(*a, pre=pre)]
        want = [t.cpu().numpy() for t in fused_step_plain(*a, pre=pre)]
        _assert_step_equal(got, want, exact_dist=integer)


# ------------------------------------------- merge by rank (K1, K5) ----
def _merge_by_rank(cd, cp, rd, ri, dist, dmask, vld, nb):
    """A torch transcription of `csrc/step_common.cuh::merge_by_rank`, the
    merge of K1/K3/K4 and K5, for lanes [B, ...]: the new run rank-sorted
    by (key, position), new entry s of it placed at s + #{old <= key},
    old entry i at i + #{new < d_i}, each written when its slot is below
    M (K). Returns the merged queue and result set, and how many times
    each output slot was written."""
    b, m = cd.shape
    k, r = rd.shape[1], dist.shape[1]
    inf = torch.tensor(float("inf"))
    kq = torch.where(dmask, dist, inf)
    kr = torch.where(dmask & vld, dist, inf)
    first = torch.arange(r)[:, None] < torch.arange(r)[None, :]  # j before r

    def rank(key):  # [B, R]: #{j : (key_j, j) < (key_r, r)}
        kj, kk = key[:, :, None], key[:, None, :]
        return ((kj < kk) | ((kj == kk) & first)).sum(1)

    def place(out_d, out_p, hits, o, keys, pays, write):
        sel = write & (o < out_d.shape[1])
        lane = torch.arange(b)[:, None].expand_as(o)[sel]
        out_d[lane, o[sel]] = keys[sel]
        out_p[lane, o[sel]] = pays[sel]
        hits.index_put_((lane, o[sel]), torch.ones_like(lane), accumulate=True)

    outs = []
    for key, old_d, old_p, width, write, pay in (
            (kq, cd, cp, m, dmask, nb | (vld.to(torch.int32) << 30)),
            (kr, rd, ri, k, dmask & vld, nb)):
        s = rank(key)
        new_sorted = torch.full_like(key, float("inf")).scatter(1, s, key)
        out_d = torch.full((b, width), float("nan"))
        out_p = torch.full((b, width), -7, dtype=torch.int32)
        hits = torch.zeros((b, width), dtype=torch.int64)
        place(out_d, out_p, hits,
              s + torch.searchsorted(old_d, key, right=True), key, pay, write)
        place(out_d, out_p, hits,
              torch.arange(width) + torch.searchsorted(new_sorted, old_d),
              old_d, old_p, torch.ones_like(old_d, dtype=torch.bool))
        outs.append((out_d, out_p, hits))
    return outs


@pytest.mark.parametrize("m,r,k", [(512, 32, 10), (512, 160, 10), (8, 3, 2)])
def test_merge_by_rank_formulas_equal_merge_stable(m, r, k):
    """The rank formulas K1/K3/K4 and K5 merge by == `merge_stable` (a
    stable argsort over [old | new], the plain versions' merge) on both
    buffers, payloads included, under heavy ties: keys from a handful of
    values, new keys equal to old ones, all-inf new runs and inf-padded
    (or all-inf) old runs; every output slot is written exactly once."""
    from repro_torch.kernels.topk import merge_stable

    b = 4

    @settings(max_examples=40, deadline=None)
    @given(seed=st.integers(0, 2 ** 31 - 1), n_vals=st.integers(1, 4),
           old_frac=st.integers(0, 4), masked=st.integers(0, 4))
    def check(seed, n_vals, old_frac, masked):
        rng = np.random.default_rng(seed)
        vals = np.sort(rng.choice([0.0, 0.25, 0.5, 1.0, 2.5, 7.0], n_vals,
                                  replace=False)).astype(np.float32)
        # old runs: sorted, the first old_frac/4 of each finite
        cd = np.full((b, m), np.inf, np.float32)
        rd = np.full((b, k), np.inf, np.float32)
        fq, fr = m * old_frac // 4, k * old_frac // 4
        cd[:, :fq] = np.sort(rng.choice(vals, (b, fq)), axis=1)
        rd[:, :fr] = np.sort(rng.choice(vals, (b, fr)), axis=1)
        cp = np.where(np.isinf(cd), -1, rng.integers(0, 1 << 29, (b, m)))
        ri = np.where(np.isinf(rd), -1, rng.integers(0, 1 << 29, (b, k)))
        # new runs: keys from the same values (ties with the old run), on
        # masked/4 of them dmask is off (masked=4: an all-inf new run)
        dist = rng.choice(vals, (b, r)).astype(np.float32)
        dmask = rng.random((b, r)) >= masked / 4
        vld = rng.random((b, r)) < 0.6
        nb = rng.integers(0, 1 << 29, (b, r))
        t = lambda a, dt=None: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a if dt is None else a.astype(dt)))
        cd, rd, dist = t(cd), t(rd), t(dist)
        cp, ri, nb = t(cp, np.int32), t(ri, np.int32), t(nb, np.int32)
        dmask, vld = t(dmask), t(vld)
        (qd, qp, qh), (rdd, rp, rh) = _merge_by_rank(cd, cp, rd, ri, dist,
                                                     dmask, vld, nb)
        inf = torch.tensor(float("inf"))
        pay = torch.where(dmask, nb | (vld.to(torch.int32) << 30), -1)
        wd, (wp,) = merge_stable(cd, (cp,), torch.where(dmask, dist, inf),
                                 (pay.to(torch.int32),), m)
        take = dmask & vld
        wrd, (wri,) = merge_stable(rd, (ri,), torch.where(take, dist, inf),
                                   (torch.where(take, nb, -1),), k)
        assert (qh == 1).all() and (rh == 1).all()
        assert torch.equal(qd, wd) and torch.equal(qp, wp)
        assert torch.equal(rdd, wrd) and torch.equal(rp, wri)

    check()


# ------------------------------------------------------------ K3, K4 ----
def _quant_step_inputs(rng, precision, b, m, r, k, n=600, d=24,
                       device="cpu", distinct=None):
    """A port quant index over grid vectors (int8: scale 1/32; PQ: trained
    codebooks rounded to the grid 1/64, 2 levels), grid queries, and one
    step's gathered inputs: every ADC distance exact in float32.
    `distinct` rows, repeated over the n, make equal distances common."""
    from repro_torch.quant import codecs as P

    grid = lambda a: np.round(a * 64) / 64  # noqa: E731
    vecs = grid(rng.normal(size=(distinct or n, d)) * 0.3)
    if distinct:
        vecs = vecs[rng.integers(0, distinct, n)]
    vecs = torch.from_numpy(vecs.astype(np.float32))
    q = np.clip(grid(rng.normal(size=(b, d)) * 0.3), -127 / 64, 127 / 64)
    if precision == "int8":
        q[:, 0] = 127 / 64  # query step sq = 1/2048
        scale = torch.full((d,), 1 / 32)
        zero = torch.zeros(d)
        codes, norms, err = P.encode_int8(scale, zero, vecs)
        index = P.Int8Index(codes, scale, zero, norms, err)
    else:
        books = P.train_pq(vecs, 8, 16, 6, 0, n_levels=2)
        books = torch.round(books * 64) / 64
        codes, norms, err = P.encode_pq(books, vecs)
        index = P.PQIndex(codes, books, norms, err)
    index = type(index)(*(t.to(device) for t in index))
    qt = torch.from_numpy(q.astype(np.float32)).to(device)
    prep = P.prepare_query(precision, index, qt)
    a = _inputs(rng, b, m, r, k, d, compiled=False)
    nb = rng.integers(0, n, (b, r)).astype(np.int32)
    nb[:, -1] = nb[:, 0]
    t = _torch_args(a, device)
    nbt = torch.from_numpy(nb).to(device)
    nbl = nbt.long()
    qg = P.QuantGather(prep=prep, codes=index.codes[nbl],
                       norms=index.norms[nbl])
    return (qt, None, nbt, *t[3:]), qg, index, prep


@pytest.mark.parametrize("precision", ["int8", "pq"])
@pytest.mark.parametrize("pre", [False, True])
def test_fused_step_plain_quant_matches_reference(precision, pre):
    """fused_step_plain under int8 (K3's plain version) and PQ (K4's) ==
    the reference's host path, and its kernel in interpret mode at micro
    widths; exact data, so every output equal."""
    import jax.numpy as jnp
    from repro.kernels.fused_step import fused_step as j_fused
    from repro.quant.codecs import (Int8Prep, PQPrep, QuantGather)

    rng = np.random.default_rng(21)
    for b, m, r, k in ((6, 64, 16, 5), (5, 8, 4, 2)):
        args, qg, _, prep = _quant_step_inputs(rng, precision, b, m, r, k)
        got = [t.numpy() for t in fused_step_plain(
            *args, pre=pre, quant=qg, precision=precision)]
        got2 = [t.numpy() for t in fused_step(
            *args, pre=pre, quant=qg, precision=precision)]
        _assert_step_equal(got2, got, exact_dist=True)
        jprep = (Int8Prep if precision == "int8" else PQPrep)(
            *(jnp.asarray(t.numpy()) for t in prep))
        codes = jnp.asarray(qg.codes.numpy())
        if precision == "pq":
            codes = codes.astype(jnp.int32)
        jqg = QuantGather(prep=jprep, codes=codes,
                          norms=jnp.asarray(qg.norms.numpy()))
        ja = list(_jax_args(tuple(np.zeros(1) if t is None else (
            t.numpy() if isinstance(t, torch.Tensor) else
            type(t)(*(u.numpy() for u in t))) for t in args)))
        ja[1] = None  # no float vectors under a codec
        want = _fused_step_host()(*ja, pre=pre, quant=jqg,
                                  precision=precision)
        _assert_step_equal(got, want, exact_dist=True)
        if m == 8:  # the reference kernel itself, at micro widths
            want = j_fused(*ja, pre=pre, quant=jqg, precision=precision,
                           interpret=True)
            _assert_step_equal(got, want, exact_dist=True)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["int8", "pq"])
@pytest.mark.parametrize("pre", [False, True])
def test_fused_step_quant_kernel_matches_plain_on_cuda(precision, pre):
    """K3 / K4 on the card == their plain version, every output equal
    (exact data: the int8 dot is integer, the PQ lookups are dyadic)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels K3/K4 have no CPU mode)")
    rng = np.random.default_rng(22)
    args, qg, _, _ = _quant_step_inputs(rng, precision, 16, 128, 32, 10,
                                        d=64, device="cuda")
    got = [t.cpu().numpy() for t in fused_step(
        *args, pre=pre, quant=qg, precision=precision)]
    want = [t.cpu().numpy() for t in fused_step_plain(
        *args, pre=pre, quant=qg, precision=precision)]
    _assert_step_equal(got, want, exact_dist=True)


# ------------------------------------------ the PQ head (K4, K5 pq) ----
# Its layout, written out (`csrc/step_common.cuh`: kPQChunk table rows a
# chunk, kPQStages chunk buffers and their mbarriers, codes rows padded to
# an odd word count).
PQ_CHUNK, PQ_STAGES = 48, 2


def _pq_head_words(r, sl, kc):
    bar_words = (2 * PQ_STAGES + 3) & ~3
    return bar_words + PQ_STAGES * PQ_CHUNK * kc + r * (((sl + 3) >> 2) | 1)


def _fused_smem_bytes(r, qw, m, k):
    """`csrc/fused_step.cu::fused_step_smem_bytes` with head words qw."""
    return 4 * (qw + 5 * r + m + k + 4 + 8 + 1)


def _persistent_smem_bytes(r, qw, m, k):
    """`csrc/persistent_step.cu::persistent_step_smem_bytes`."""
    return 4 * (qw + 4 * m + 4 * k + 6 * r + 4 + 3 * 8 + 1 + 4
                + (1 << (r - 1).bit_length()))


def _pq_head_chunked(lut, codes, norms, qn, use=None):
    """A torch transcription of `csrc/step_common.cuh::pq_head` for one
    lane: lut [SL, Kc] f32, codes [R, SL] uint8, norms [R] f32, qn a 0-d
    f32 tensor, use [R] bool (K5's isnew; None: every row, as K4). The used
    rows' codes go into words, each row padded to an odd word count; the
    table goes by chunks of PQ_CHUNK rows into PQ_STAGES buffers in turn; each
    used row adds its lookups of a chunk, read from the buffer through its
    code words, to its sum carried across chunks, in slot order. Returns
    (ip [R], dist [R], how many times each (row, slot) was looked up, the
    shared-memory words used)."""
    r_, sl = codes.shape
    kc = lut.shape[1]
    use = torch.ones(r_, dtype=torch.bool) if use is None else use
    ld = ((sl + 3) >> 2) | 1
    padded = torch.full((r_, 4 * ld), 0xAB, dtype=torch.uint8)  # unused
    padded[use, :sl] = codes[use]
    cw = padded.view(torch.int32).to(torch.int64) & 0xFFFFFFFF   # [R, ld]
    bufs = [torch.full((PQ_CHUNK, kc), float("nan"))
            for _ in range(PQ_STAGES)]
    rows = torch.nonzero(use)[:, 0]
    ip = torch.zeros(r_, dtype=torch.float32)
    hits = torch.zeros((r_, sl), dtype=torch.int64)
    for c, j0 in enumerate(range(0, sl, PQ_CHUNK)):
        n = min(PQ_CHUNK, sl - j0)
        t = bufs[c % PQ_STAGES]
        t[:n] = lut[j0:j0 + n]                     # the chunk's bulk copy
        for jj in range(n):                        # one thread a row
            j = j0 + jj
            code = (cw[rows, j >> 2] >> (8 * (j & 3))) & 255
            ip[rows] = ip[rows] + t[jj, code]
            hits[rows, j] += 1
    dist = torch.clamp((qn + norms) - 2.0 * ip, min=0.0)
    return ip, dist, hits, _pq_head_words(r_, sl, kc)


def _slot_order_sum(lut, codes):
    """Row by row, ((0 + lut[0, c_0]) + lut[1, c_1]) + …: float32 adds in a
    Python loop over the slots, each rounded once."""
    vals = lut.numpy()[np.arange(codes.shape[1])[None, :], codes.numpy()]
    acc = np.zeros(codes.shape[0], np.float32)
    for j in range(codes.shape[1]):
        acc = (acc + vals[:, j]).astype(np.float32)
    return acc


def test_pq_head_chunks_equal_slot_order_sum():
    """The chunked PQ head (`_pq_head_chunked`) == the slot-order sum bit
    for bit on float data, at R ∈ {1, 7, 32, 160}, S·L off a multiple of
    PQ_CHUNK (and off 4) and rows masked as K5 masks visited ones; every
    used (row, slot) looked up once, no masked row."""

    @settings(max_examples=30, deadline=None)
    @given(seed=st.integers(0, 2 ** 31 - 1), ri=st.integers(0, 3),
           sl=st.sampled_from([1, 3, 13, 64, 100, 130, 191, 576]),
           kc=st.sampled_from([2, 16, 256]), masked=st.integers(0, 3))
    def check(seed, ri, sl, kc, masked):
        rng = np.random.default_rng(seed)
        r = (1, 7, 32, 160)[ri]
        lut = torch.from_numpy((rng.normal(size=(sl, kc))
                                * 10.0 ** rng.integers(-3, 3, (sl, 1)))
                               .astype(np.float32))
        codes = torch.from_numpy(rng.integers(0, kc, (r, sl)).astype(np.uint8))
        norms = torch.from_numpy((rng.random(r) * 4).astype(np.float32))
        qn = torch.tensor(np.float32(rng.random() * 4))
        use = (torch.from_numpy(rng.random(r) >= masked / 4) if masked
               else None)
        ip, dist, hits, words = _pq_head_chunked(lut, codes, norms, qn, use)
        used = torch.ones(r, dtype=torch.bool) if use is None else use
        assert torch.equal(hits, used[:, None].long().expand(r, sl))
        want = torch.from_numpy(_slot_order_sum(lut, codes))
        assert torch.equal(ip[used].view(torch.int32),
                           want[used].view(torch.int32))
        assert torch.equal(dist[used], torch.clamp(
            (qn + norms[used]) - 2.0 * want[used], min=0.0))

    check()


def test_pq_head_chunks_match_fused_step_plain_on_grid():
    """On `tests/_quant_grid.py` data (S·L = 96: two chunks, the second
    partial) `_pq_head_chunked` == `fused_step_plain`'s PQ distances (one
    post-mode step from an empty queue: its queue is the R distances,
    sorted) and `quant_dist`'s with K5's isnew mask, bit for bit."""
    from _quant_grid import grid_index, grid_queries

    from repro_torch.convert import quant_to_torch
    from repro_torch.quant import codecs as P

    rng = np.random.default_rng(31)
    n, d, b, m, r, k = 300, 96, 4, 64, 32, 5
    vecs = (np.round(rng.normal(size=(n, d)) * 0.3 * 64) / 64).astype(
        np.float32)
    index = quant_to_torch(grid_index("pq", vecs, pq_subspaces=48,
                                      pq_centroids=16, pq_levels=2), "cpu")
    q = torch.from_numpy(grid_queries(rng.normal(size=(b, d)) * 0.3, "pq"))
    prep = P.prepare_query("pq", index, q)
    assert prep.lut.shape[1] == 96
    nb = torch.from_numpy(rng.integers(0, n, (b, r)).astype(np.int32))
    nb[:, -1] = nb[:, 0]
    qg = P.QuantGather(prep=prep, codes=index.codes[nb.long()],
                       norms=index.norms[nb.long()])
    a = list(_torch_args(_inputs(rng, b, m, r, k, d, compiled=False)))
    a[0], a[1], a[2] = q, None, nb
    a[3] = torch.ones((b, r), dtype=torch.bool)                 # all new
    a[7] = torch.full((b, m), INF)                              # empty queue
    a[8] = torch.full((b, m), -1, dtype=torch.int32)
    ocd = fused_step_plain(*a, quant=qg, precision="pq")[0]
    want = P.quant_dist("pq", qg)
    for lane in range(b):
        args = (prep.lut[lane], qg.codes[lane], qg.norms[lane], prep.qn[lane])
        _, dist, _, _ = _pq_head_chunked(*args)
        assert torch.equal(torch.sort(dist).values, ocd[lane, :r])
        use = torch.from_numpy(rng.random(r) < 0.6)
        _, dist, _, _ = _pq_head_chunked(*args, use=use)
        assert torch.equal(dist[use], want[lane][use])


@pytest.mark.parametrize("r,sl", [(160, 576), (32, 576)])
def test_pq_head_shared_memory_fits_a_block(r, sl):
    """`fused_step_smem_bytes` and `persistent_step_smem_bytes`, written
    out, at M=512, K=10, Kc=256 with the PQ head's words: a row costs its
    codes' words (S·L/4), not its S·L lookups, and both fit one H100 block
    at the widened frontier R'=160 and the 1-hop R=32, where the whole-row
    staging (R·(S·L | 1) words) took 369,280 B at R'=160."""
    from repro_torch.kernels._build import MAX_SMEM_BYTES

    m, k, kc = 512, 10, 256
    qw = _pq_head_words(r, sl, kc)
    assert _pq_head_words(r + 1, sl, kc) - qw == ((sl + 3) >> 2) | 1
    fused = _fused_smem_bytes(r, qw, m, k)
    persistent = _persistent_smem_bytes(r, qw, m, k)
    assert fused <= MAX_SMEM_BYTES and persistent <= MAX_SMEM_BYTES
    if r == 160:
        assert 4 * r * (sl | 1) == 369_280 > MAX_SMEM_BYTES
        assert fused == 196_460


@pytest.mark.cuda
@pytest.mark.parametrize("r,sl,kc", [(160, 576, 256), (32, 576, 256),
                                     (7, 99, 13)])
def test_pq_head_shared_memory_formula_is_the_libraries_on_cuda(r, sl, kc):
    """The written-out PQ shared-memory sizes above == what the built
    libraries ask for (the wrappers check blocks against theirs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the built libraries)")
    from repro_torch.kernels.fused_step import _lib as fused_lib
    from repro_torch.kernels.persistent_step import _lib as persistent_lib

    m, k, qw = 512, 10, _pq_head_words(r, sl, kc)
    assert fused_lib().fused_step_smem_bytes(2, r, sl, m, k, kc) == \
        _fused_smem_bytes(r, qw, m, k)
    assert persistent_lib().persistent_step_smem_bytes(2, r, sl, m, k, kc) \
        == _persistent_smem_bytes(r, qw, m, k)


def _with_ties(args, dnew, rng):
    """One step's inputs rebuilt for ties in the merges: old queue and
    result keys taken from the new distances `dnew` [B, R] (equal keys
    across old and new), an all-inf queue and result set in lanes 1 mod 3,
    every new entry masked (none first-visit) in lanes 2 mod 3."""
    q, x, nb, is_new, prog, labels, values, cd, cp, rd, ri = args
    b, m = cd.shape
    k, r = rd.shape[1], dnew.shape[1]
    base = torch.sort(dnew.cpu(), dim=1).values
    half = base.repeat(1, (m // 2 + r - 1) // r)[:, : m // 2]
    cd = torch.sort(torch.cat([half, torch.full((b, m - m // 2), INF)], 1),
                    dim=1).values
    rd = torch.sort(torch.cat([base[:, : k // 2].repeat(1, 2)[:, : k // 2],
                               torch.full((b, k - k // 2), INF)], 1),
                    dim=1).values
    cd[1::3] = INF
    rd[1::3] = INF
    cp = torch.from_numpy(rng.integers(0, 1 << 29, (b, m)).astype(np.int32))
    ri = torch.from_numpy(rng.integers(0, 1 << 29, (b, k)).astype(np.int32))
    cp[torch.isinf(cd)] = -1
    ri[torch.isinf(rd)] = -1
    is_new = is_new.clone()
    is_new[2::3] = False
    dev = nb.device
    return (q, x, nb, is_new.to(dev), prog, labels, values, cd.to(dev),
            cp.to(dev), rd.to(dev), ri.to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("precision,r", [("float32", 32), ("float32", 160),
                                         ("int8", 32), ("pq", 32),
                                         ("pq", 160)])
@pytest.mark.parametrize("pre", [False, True])
def test_fused_step_merge_ties_match_plain_on_cuda(precision, r, pre):
    """K1 and K4 (R=32 and the widened R'=160) and K3 on the card == their
    plain version in every field, bit for bit, on grid data whose rows
    repeat: new distances equal to queued ones, all-inf queues and runs
    with every new entry masked (`_with_ties`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels K1/K3/K4 have no CPU mode)")
    from repro_torch.kernels.distance import sqdist_bdrd
    from repro_torch.quant.codecs import quant_dist

    rng = np.random.default_rng(23 + r)
    b, m, k, d = 12, 128, 10, 64
    if precision == "float32":
        a = _inputs(rng, b, m, r, k, d, integer=True, compiled=False)
        a[1][:] = a[1][:, np.arange(r) % 4]   # 4 distinct rows a lane
        args, kw = _torch_args(a, "cuda"), {}
        dnew = sqdist_bdrd(args[0], args[1])
    else:
        args, qg, _, _ = _quant_step_inputs(rng, precision, b, m, r, k,
                                            d=d, device="cuda", distinct=6)
        kw = dict(quant=qg, precision=precision)
        dnew = quant_dist(precision, qg)
    args = _with_ties(args, dnew, rng)
    got = [t.cpu().numpy() for t in fused_step(*args, pre=pre, **kw)]
    want = [t.cpu().numpy() for t in fused_step_plain(*args, pre=pre, **kw)]
    _assert_step_equal(got, want, exact_dist=True)
    with np.errstate(invalid="ignore"):  # inf - inf pads
        assert (np.diff(want[0][0::3], axis=1) == 0).any(), "no ties"


@pytest.mark.cuda
@pytest.mark.parametrize("sl,kc,shift", [(576, 256, 1), (99, 13, 0),
                                         (130, 12, 0)])
def test_fused_step_pq_table_routes_match_plain_on_cuda(sl, kc, shift):
    """K4 at R'=160 on the card == its plain version in every field, bit
    for bit on grid data, whichever way the lane's table comes into shared
    memory: a bulk copy a chunk (S·L·Kc a multiple of 4, 16-byte aligned;
    S·L=130 ends on a partial chunk and takes its codes byte by byte) or
    4-byte copies by every thread (a table shifted off 16-byte alignment,
    or S·L·Kc odd)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel K4 has no CPU mode)")
    from repro_torch.quant.codecs import PQPrep, QuantGather

    rng = np.random.default_rng(sl + kc)
    b, m, r, k = 8, 128, 160, 10
    a = list(_torch_args(_inputs(rng, b, m, r, k, 16, compiled=False),
                         "cuda"))
    grid = lambda z: torch.from_numpy(  # noqa: E731
        (np.round(z * 64) / 64).astype(np.float32)).cuda()
    flat = torch.zeros(b * sl * kc + shift, device="cuda")
    flat[shift:] = grid(rng.normal(size=b * sl * kc) * 0.05)
    lut = flat[shift:].view(b, sl, kc)
    assert (lut.data_ptr() % 16 != 0) == (shift != 0)
    codes = torch.from_numpy(rng.integers(0, kc, (b, r, sl)).astype(
        np.uint8)).cuda()
    qg = QuantGather(prep=PQPrep(lut=lut, qn=grid(rng.random(b) * 4)),
                     codes=codes, norms=grid(rng.random((b, r)) * 4))
    a[1] = None
    for pre in (False, True):
        got = [t.cpu().numpy() for t in fused_step(
            *a, pre=pre, quant=qg, precision="pq")]
        want = [t.cpu().numpy() for t in fused_step_plain(
            *a, pre=pre, quant=qg, precision="pq")]
        _assert_step_equal(got, want, exact_dist=True)


def test_payload_pack_roundtrip():
    idx = torch.tensor([-1, 0, 5, (1 << 29) - 1], dtype=torch.int32)
    exp = torch.tensor([False, True, False, True])
    val = torch.tensor([False, False, True, True])
    i2, e2, v2 = unpack_payload(pack_payload(idx, exp, val))
    assert torch.equal(i2, idx)
    assert torch.equal(e2[1:], exp[1:]) and torch.equal(v2[1:], val[1:])
    assert not e2[0] and not v2[0]


@functools.lru_cache(maxsize=None)
def _fused_step_host():
    """The reference host path, jitted (eagerly it compiles every
    primitive op on first use)."""
    import jax
    from repro.kernels.fused_step import fused_step_host

    return jax.jit(fused_step_host, static_argnames=("pre", "precision"))


def _forest(seed, n, f, trees, depth, train=train_gbdt):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = x[:, 0] * 2 + np.sin(x[:, min(1, f - 1)]) + 0.1 * rng.normal(size=n)
    return x, train(x, y, n_trees=trees, depth=depth, learning_rate=0.2)


@pytest.mark.parametrize("n,f,trees,depth", [(64, 8, 20, 3), (128, 28, 60, 5),
                                             (33, 68, 200, 5)])
def test_gbdt_plain_matches_reference(n, f, trees, depth):
    import jax.numpy as jnp
    from repro.core.gbdt import train_gbdt as j_train_gbdt
    from repro.kernels.gbdt import gbdt_predict as jax_gbdt_predict

    x, model = _forest(n + f, n, f, trees, depth, j_train_gbdt)
    want_k = np.asarray(jax_gbdt_predict(
        jnp.asarray(x), jnp.asarray(model.feat), jnp.asarray(model.thresh),
        jnp.asarray(model.leaf), model.base, depth, interpret=True))
    port = gbdt_from_arrays(model.feat, model.thresh, model.leaf, model.base,
                            model.depth, model.importances)
    feat, thresh, leaf, base = port.packed("cpu")
    got = gbdt_predict_plain(torch.from_numpy(x), feat, thresh, leaf, base,
                             depth).numpy()
    np.testing.assert_allclose(got, want_k, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, model.predict(x), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(port.predict(x), model.predict(x))
    got2 = gbdt_predict(torch.from_numpy(x), feat, thresh, leaf, base,
                        depth).numpy()
    np.testing.assert_array_equal(got2, got)


@pytest.mark.cuda
def test_gbdt_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel K2 has no CPU mode)")
    x, model = _forest(3, 100, 68, 200, 5)
    port = gbdt_from_arrays(model.feat, model.thresh, model.leaf, model.base,
                            model.depth)
    feat, thresh, leaf, base = port.packed("cuda")
    xt = torch.from_numpy(x).cuda()
    got = gbdt_predict(xt, feat, thresh, leaf, base, 5)
    want = gbdt_predict_plain(xt, feat, thresh, leaf, base, 5)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _gbdt_tree_order(feats, feat, thresh, leaf, base, depth):
    """A torch transcription of `csrc/gbdt.cu`: block b takes lane b, and
    its thread j trees j, j + threads, ... (threads: T rounded up to a
    warp, 32 to 1024); each walk goes in rounds of up to three levels
    (`walk_round`: the 2^K − 1 nodes under and including n, level j's at
    heap indices (n + 1)·2^j − 1 + q, the last round also the 2^K leaves
    below), descending by the position p within each level; thread 0 then
    adds the T leaf values in tree order from 0, then `base`. Returns
    ([B] f32, how many times each (lane, tree) pair was walked)."""
    b, t = feats.shape[0], feat.shape[0]
    ni = feat.shape[1]
    threads = min(max(-(-t // 32) * 32, 32), 1024)
    walked = torch.zeros((b, t), dtype=torch.int64)
    sv = torch.zeros((b, t), dtype=torch.float32)
    lanes = torch.arange(b)[:, None]
    for t0 in range(0, t, threads):  # one pass of the block's threads
        trees = torch.arange(t0, min(t0 + threads, t))[None, :].expand(b, -1)

        def walk_round(n, k, leaves):
            p = torch.zeros_like(n)
            for j in range(k):
                node = ((n + 1) << j) - 1 + p
                f = feat[trees, node].long()
                p = 2 * p + (~(feats[lanes, f] <= thresh[trees, node])).long()
            below = ((n + 1) << k) - 1
            return below + p, (leaf[trees, below - ni + p] if leaves
                               else None)

        n = torch.zeros_like(trees)
        d = 0
        while depth - d > 3:
            n, _ = walk_round(n, 3, False)
            d += 3
        if depth > d:
            _, v = walk_round(n, depth - d, True)
        else:
            v = leaf[trees, n - ni]
        sv[lanes, trees] = v
        walked[lanes, trees] += 1
    s = torch.zeros(b, dtype=torch.float32)
    for j in range(t):
        s = s + sv[:, j]
    return torch.tensor(base, dtype=torch.float32) + s, walked


def _tree_by_tree_sum(x, feat, thresh, leaf, base, depth):
    """numpy: each tree's leaf by the heap walk, then float32 adds in
    tree order from 0, each rounded once, then base."""
    n, ni = x.shape[0], feat.shape[1]
    acc = np.zeros(n, np.float32)
    for t in range(feat.shape[0]):
        idx = np.zeros(n, np.int64)
        for _ in range(depth):
            go_left = x[np.arange(n), feat[t, idx]] <= thresh[t, idx]
            idx = 2 * idx + 1 + (~go_left)
        acc = (acc + leaf[t, idx - ni]).astype(np.float32)
    return (np.float32(base) + acc).astype(np.float32)


def _random_forest(rng, b, f, t, depth, inf_frac=0.2):
    """Features [b, f] and a random forest of t trees: every tree tests
    feature f - 1 somewhere, about inf_frac of thresholds are +inf (the
    unused nodes of a trained forest), leaves of mixed magnitude."""
    ni, nl = (1 << depth) - 1, 1 << depth
    x = rng.normal(size=(b, f)).astype(np.float32)
    feat = rng.integers(0, f, (t, ni)).astype(np.int32)
    feat[:, rng.integers(0, ni)] = f - 1
    thresh = rng.normal(size=(t, ni)).astype(np.float32)
    thresh[rng.random((t, ni)) < inf_frac] = np.inf
    leaf = (rng.normal(size=(t, nl))
            * 10.0 ** rng.integers(-3, 2, (t, 1))).astype(np.float32)
    return x, feat, thresh, leaf, float(np.float32(rng.normal() * 4))


GBDT_TREES, GBDT_LANES = (1, 7, 200, 401), (1, 33, 64, 130)


def test_gbdt_tree_order_equals_tree_by_tree_sum():
    """K2's transcription (`_gbdt_tree_order`) == a float32 tree-by-tree
    sum plus base, bit for bit, over T ∈ {1, 7, 200, 401}, depth 1–6,
    B ∈ {1, 33, 64, 130}, with +inf thresholds and feature F − 1; every
    (lane, tree) pair walked once."""

    @settings(max_examples=40, deadline=None)
    @given(seed=st.integers(0, 2 ** 31 - 1), ti=st.integers(0, 3),
           depth=st.integers(1, 6), bi=st.integers(0, 3),
           f=st.integers(1, 70))
    def check(seed, ti, depth, bi, f):
        rng = np.random.default_rng(seed)
        x, feat, thresh, leaf, base = _random_forest(
            rng, GBDT_LANES[bi], f, GBDT_TREES[ti], depth)
        t = torch.from_numpy
        got, walked = _gbdt_tree_order(t(x), t(feat), t(thresh), t(leaf),
                                       base, depth)
        assert (walked == 1).all()
        want = _tree_by_tree_sum(x, feat, thresh, leaf, base, depth)
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))

    check()


@pytest.mark.parametrize("t,depth,b", [(1, 1, 1), (7, 3, 33), (200, 5, 64),
                                       (401, 6, 130), (200, 2, 130),
                                       (7, 4, 1)])
@pytest.mark.parametrize("trained", [False, True])
def test_gbdt_tree_order_matches_plain_and_reference(t, depth, b, trained):
    """`_gbdt_tree_order` == `gbdt_predict_plain` and the reference's
    `gbdt_predict(interpret=True)` within rtol/atol 1e-5 (they sum the
    leaves in other orders), on a random forest (+inf thresholds, feature
    F − 1) and on a trained one."""
    import jax.numpy as jnp
    from repro.kernels.gbdt import gbdt_predict as jax_gbdt_predict

    rng = np.random.default_rng(t * 100 + depth * 10 + b)
    f = 68
    if trained:
        _, model = _forest(t + depth, 256, f, t, depth)
        x = rng.normal(size=(b, f)).astype(np.float32)
        feat, thresh, leaf, base = (model.feat, model.thresh, model.leaf,
                                    float(np.float32(model.base)))
    else:
        x, feat, thresh, leaf, base = _random_forest(rng, b, f, t, depth)
    tt = torch.from_numpy
    got, _ = _gbdt_tree_order(tt(x), tt(feat), tt(thresh), tt(leaf), base,
                              depth)
    plain = gbdt_predict_plain(tt(x), tt(feat), tt(thresh), tt(leaf), base,
                               depth)
    ref = np.asarray(jax_gbdt_predict(
        jnp.asarray(x), jnp.asarray(feat), jnp.asarray(thresh),
        jnp.asarray(leaf), base, depth, interpret=True))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_cost_estimator_keeps_its_forest_per_device(monkeypatch):
    """`CostEstimator.packed(device)` uploads the forest once per device:
    a second call returns the same tensors, predict_budget and
    e2e-style calls with and without `packed` give the same budgets, and
    the cache is no part of the estimator's value (==, repr)."""
    from repro_torch.core.estimator import CostEstimator
    from repro_torch.core.gbdt import GBDTModel

    x, model = _forest(5, 128, 12, 30, 4)
    est = CostEstimator(model=model)
    uploads = []
    real = GBDTModel.packed
    monkeypatch.setattr(GBDTModel, "packed",
                        lambda self, dev: uploads.append(dev) or real(self,
                                                                      dev))
    feats = torch.from_numpy(x[:40])
    first = est.predict_budget(feats, 1.5, 32, 10 ** 6)
    p1 = est.packed("cpu")
    p2 = est.packed(torch.device("cpu"))
    assert all(a is b for a, b in zip(p1, p2))
    again = est.predict_budget(feats, 1.5, 32, 10 ** 6, packed=p1)
    assert len(uploads) == 1
    fresh = CostEstimator(model=model).predict_budget(
        feats, 1.5, 32, 10 ** 6, packed=real(model, "cpu"))
    assert torch.equal(first, again) and torch.equal(first, fresh)
    assert est == CostEstimator(model=model)
    assert "_forest" not in repr(est)


@pytest.mark.cuda
@pytest.mark.parametrize("t", GBDT_TREES)
@pytest.mark.parametrize("trained", [False, True])
def test_gbdt_kernel_equals_tree_order_sum_on_cuda(t, trained):
    """K2 == the float32 tree-by-tree sum plus base, bit for bit, at
    depth 1–6 and B ∈ {1, 33, 64, 130}, on random forests (+inf
    thresholds, feature F − 1) and trained ones (`_forest`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel K2 has no CPU mode)")
    rng = np.random.default_rng(t)
    f = 68
    for depth in range(1, 7):
        if trained:
            _, model = _forest(t + depth, 256, f, t, depth)
        for b in GBDT_LANES:
            if trained:
                x = rng.normal(size=(b, f)).astype(np.float32)
                feat, thresh, leaf, base = model.feat, model.thresh, \
                    model.leaf, float(np.float32(model.base))
            else:
                x, feat, thresh, leaf, base = _random_forest(rng, b, f, t,
                                                             depth)
            args = [torch.from_numpy(a).cuda() for a in (x, feat, thresh,
                                                         leaf)]
            got = gbdt_predict(*args, base, depth).cpu().numpy()
            want = _tree_by_tree_sum(x, feat, thresh, leaf, base, depth)
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32),
                                          err_msg=f"T={t} D={depth} B={b}")


# ---------------------------------------------------------------- K6 ----
def _sqdist_inputs(rng, b, r, d, grid):
    q = rng.normal(size=(b, d)).astype(np.float32)
    x = rng.normal(size=(b, r, d)).astype(np.float32)
    if grid:  # every squared distance exact in float32
        q, x = (np.round(a * 64) / 64 for a in (q, x))
    mask = rng.random((b, r)) < 0.7
    return q.astype(np.float32), x.astype(np.float32), mask


@pytest.mark.parametrize("grid", [True, False])
@pytest.mark.parametrize("b,r,d", [(5, 17, 40), (8, 32, 96)])
def test_sqdist_masked_plain_matches_reference(b, r, d, grid):
    """sqdist_masked_plain (and the CPU wrapper) == the reference kernel
    in interpret mode: exact on grid data, rtol 1e-5 otherwise."""
    import jax.numpy as jnp
    from repro.kernels.distance import sqdist_masked as j_sqdist_masked

    rng = np.random.default_rng(b * r + d + grid)
    q, x, mask = _sqdist_inputs(rng, b, r, d, grid)
    want = np.asarray(j_sqdist_masked(jnp.asarray(q), jnp.asarray(x),
                                      jnp.asarray(mask), interpret=True))
    t = torch.from_numpy
    got = sqdist_masked_plain(t(q), t(x), t(mask)).numpy()
    np.testing.assert_array_equal(np.isinf(got), ~mask)
    np.testing.assert_array_equal(np.isinf(want), ~mask)
    if grid:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got[mask], want[mask], rtol=1e-5)
    np.testing.assert_array_equal(sqdist_masked(t(q), t(x), t(mask)).numpy(),
                                  got)


@pytest.mark.cuda
def test_sqdist_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel K6 has no CPU mode)")
    rng = np.random.default_rng(12)
    for grid in (True, False):
        q, x, mask = (torch.from_numpy(a).cuda()
                      for a in _sqdist_inputs(rng, 64, 32, 768, grid))
        got = sqdist_masked(q, x, mask).cpu()
        want = sqdist_masked_plain(q, x, mask).cpu()
        assert torch.equal(torch.isinf(got), ~mask.cpu())
        if grid:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)


@pytest.mark.cuda
def test_sqdist_kernel_equals_fused_step_on_cuda():
    """K6's value for each (query, row) pair == K1's, bit for bit: one K1
    step from an all-inf queue with M >= R stores every new pair's
    distance, found again by its payload (the row's position)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels K1 and K6 have no CPU mode)")
    rng = np.random.default_rng(13)
    b, m, r, k, d = 16, 128, 32, 10, 768
    for integer in (True, False):
        a = list(_torch_args(_inputs(rng, b, m, r, k, d, integer,
                                     compiled=False), "cuda"))
        q, x = a[0], a[1]
        a[2] = torch.arange(r, dtype=torch.int32, device="cuda").repeat(b, 1)
        a[3] = torch.ones((b, r), dtype=torch.bool, device="cuda")
        a[7] = torch.full_like(a[7], INF)
        a[8] = torch.full_like(a[8], -1)
        cd, cp = fused_step(*a)[:2]
        k6 = sqdist_masked(q, x, a[3])
        pos = unpack_payload(cp[:, :r])[0].long()
        torch.cuda.synchronize()
        assert torch.isinf(cd[:, r:]).all()
        assert torch.equal(torch.sort(pos, dim=1)[0], a[2].long())
        assert torch.equal(cd[:, :r], torch.gather(k6, 1, pos))


# ---------------------------------------------------------------- K5 ----
@pytest.mark.cuda
@pytest.mark.parametrize("greedy", [False, True])
def test_persistent_kernel_matches_plain_on_cuda(greedy):
    """K5 on the card == its plain version on grid data, every field:
    lanes stop mid-launch on budget, some enter inactive, ids repeat."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel K5 has no CPU mode)")
    from repro_torch.convert import state_to_numpy
    from repro_torch.core import SearchConfig, init_state
    from repro_torch.filters import FilterSpec
    from repro_torch.filters.compile import compile_spec
    from repro_torch.filters.predicates import PRED_RANGE
    from repro_torch.kernels.persistent_step import (
        persistent_multi_step, persistent_multi_step_plain)

    rng = np.random.default_rng(5)
    n, dim, r, b, m, k = 4096, 64, 16, 24, 64, 8
    dev = "cuda"
    vecs = np.clip(np.round(rng.normal(size=(n, dim)) * 4) / 8, -2, 2)
    nbrs = rng.integers(0, n, size=(n, r)).astype(np.int32)
    nbrs[::3, 2] = nbrs[::3, 1]
    nbrs[::7, -1] = -1
    labels = rng.integers(0, 1 << 16, size=(n, 1)).astype(np.int32)
    values = rng.random((n, 1)).astype(np.float32)
    queries = np.round(rng.normal(size=(b, dim)) * 4) / 8
    spec = FilterSpec(PRED_RANGE, None, np.full(b, 0.1, np.float32),
                      np.full(b, 0.8, np.float32))
    t = lambda a, dt=None: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
        a if dt is None else a.astype(dt))).to(dev)
    cfg = SearchConfig(k=k, queue_size=m, degree=r, greedy_stop=greedy)
    prog = program_to_torch(compile_spec(spec, 1), dev)
    args = (cfg, t(queries, np.float32), prog, t(vecs, np.float32),
            (t(labels), t(values)), t(nbrs),
            t(rng.integers(30, 400, size=b), np.int32))
    state = init_state(cfg, args[1], prog, args[3], args[4], 0)
    state = persistent_multi_step_plain(*args, state, 10 ** 6, None, steps=5)
    state = state._replace(active=t(rng.random(b) < 0.9))
    gt = t(np.sort(rng.random((b, k)) * 60, axis=1), np.float32)
    for steps in (1, 8, 40):
        copy = lambda s: type(s)(*(a.clone() for a in s))  # noqa: E731
        got = persistent_multi_step(*args, copy(state), 10 ** 6, gt,
                                    steps=steps)
        want = persistent_multi_step_plain(*args, copy(state), 10 ** 6, gt,
                                           steps=steps)
        torch.cuda.synchronize()
        for name, g, w in zip(got._fields, state_to_numpy(got),
                              state_to_numpy(want)):
            np.testing.assert_array_equal(g, w, f"steps={steps}: {name}")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["int8", "pq"])
def test_build_quant_index_numpy_input_lands_on_the_card(precision):
    """Numpy vectors and no `device`: the codec is trained and encoded on
    the card, and equals the one built from the same tensors placed there
    first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the default device is the card)")
    from repro_torch.quant import codecs as P

    rng = np.random.default_rng(13)
    vecs = rng.normal(size=(600, 24)).astype(np.float32)
    cfg = dict(pq_subspaces=6, pq_centroids=16, pq_iters=4)
    got = P.build_quant_index(precision, vecs, train_sample=vecs[:300], **cfg)
    want = P.build_quant_index(precision, torch.from_numpy(vecs).cuda(),
                               train_sample=torch.from_numpy(vecs[:300]),
                               device="cuda", **cfg)
    for name, g, w in zip(got._fields, got, want):
        assert g.device.type == "cuda", name
        assert torch.equal(g, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["int8", "pq"])
def test_persistent_kernel_codecs_match_plain_on_cuda(precision):
    """K5's int8 and PQ branches on the card == the plain version on exact
    data, every field (q_err_sum included): lanes stop mid-launch, ids
    repeat, convergence fires."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel K5 has no CPU mode)")
    from repro_torch.convert import state_to_numpy
    from repro_torch.core import SearchConfig, init_state
    from repro_torch.filters import FilterSpec
    from repro_torch.filters.compile import compile_spec
    from repro_torch.filters.predicates import PRED_RANGE
    from repro_torch.kernels.persistent_step import (
        persistent_multi_step, persistent_multi_step_plain)

    rng = np.random.default_rng(6)
    n, r, b, m, k = 600, 16, 24, 64, 8
    dev = "cuda"
    _, _, index, prep = _quant_step_inputs(rng, precision, b, m, r, k, n=n,
                                           d=64, device=dev)
    vecs = torch.zeros((n, 64), device=dev)  # unread under a codec
    nbrs = rng.integers(0, n, size=(n, r)).astype(np.int32)
    nbrs[::3, 2] = nbrs[::3, 1]
    nbrs[::7, -1] = -1
    labels = rng.integers(0, 1 << 16, size=(n, 1)).astype(np.int32)
    values = rng.random((n, 1)).astype(np.float32)
    spec = FilterSpec(PRED_RANGE, None, np.full(b, 0.1, np.float32),
                      np.full(b, 0.8, np.float32))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    cfg = SearchConfig(k=k, queue_size=m, degree=r, precision=precision)
    prog = program_to_torch(compile_spec(spec, 1), dev)
    queries = torch.zeros((b, 64), device=dev)
    args = (cfg, queries, prog, vecs, (t(labels), t(values)), t(nbrs),
            t(rng.integers(30, 400, size=b).astype(np.int32)))
    kw = dict(quant=index, qprep=prep)
    state = init_state(cfg, queries, prog, vecs, args[4], 0, **kw)
    state = persistent_multi_step_plain(*args, state, 10 ** 6, None, steps=3,
                                        **kw)
    state = state._replace(active=t(rng.random(b) < 0.9))
    gt = persistent_multi_step_plain(
        *args, type(state)(*(a.clone() for a in state)), 10 ** 6, None,
        steps=4, **kw).res_dist
    for steps in (1, 8, 40):
        copy = lambda s: type(s)(*(a.clone() for a in s))  # noqa: E731
        got = persistent_multi_step(*args, copy(state), 10 ** 6, gt,
                                    steps=steps, **kw)
        want = persistent_multi_step_plain(*args, copy(state), 10 ** 6, gt,
                                           steps=steps, **kw)
        torch.cuda.synchronize()
        for name, g, w in zip(got._fields, state_to_numpy(got),
                              state_to_numpy(want)):
            np.testing.assert_array_equal(g, w, f"steps={steps}: {name}")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float32", "int8", "pq"])
def test_persistent_kernel_merge_ties_match_plain_on_cuda(precision):
    """K5's three branches on the card == the plain version in every field
    on grid data with 16 distinct rows (queued and new distances equal),
    with lanes whose queue is all inf (1 mod 4), lanes whose every
    neighbor is already visited, so each new run is all masked (2 mod 4),
    and lanes fresh from init_state (3 mod 4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel K5 has no CPU mode)")
    from repro_torch.convert import state_to_numpy
    from repro_torch.core import SearchConfig, init_state
    from repro_torch.filters import FilterSpec
    from repro_torch.filters.compile import compile_spec
    from repro_torch.filters.predicates import PRED_RANGE
    from repro_torch.kernels.persistent_step import (
        persistent_multi_step, persistent_multi_step_plain)

    rng = np.random.default_rng(8)
    n, dim, r, b, m, k = 2048, 64, 16, 24, 64, 8
    dev = "cuda"
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    kw = {}
    if precision == "float32":
        pool = np.clip(np.round(rng.normal(size=(16, dim)) * 4) / 8, -2, 2)
        vecs = t(pool[rng.integers(0, 16, n)].astype(np.float32))
        queries = t((np.round(rng.normal(size=(b, dim)) * 4) / 8)
                    .astype(np.float32))
    else:
        _, _, index, prep = _quant_step_inputs(rng, precision, b, m, r, k,
                                               n=n, d=dim, device=dev,
                                               distinct=16)
        vecs = torch.zeros((n, dim), device=dev)  # unread under a codec
        queries = torch.zeros((b, dim), device=dev)
        kw = dict(quant=index, qprep=prep)
    nbrs = rng.integers(0, n, size=(n, r)).astype(np.int32)
    nbrs[::3, 2] = nbrs[::3, 1]
    labels = rng.integers(0, 1 << 16, size=(n, 1)).astype(np.int32)
    values = rng.random((n, 1)).astype(np.float32)
    spec = FilterSpec(PRED_RANGE, None, np.full(b, 0.1, np.float32),
                      np.full(b, 0.8, np.float32))
    cfg = SearchConfig(k=k, queue_size=m, degree=r, precision=precision)
    prog = program_to_torch(compile_spec(spec, 1), dev)
    args = (cfg, queries, prog, vecs, (t(labels), t(values)), t(nbrs),
            t(rng.integers(30, 400, size=b).astype(np.int32)))
    fresh = init_state(cfg, queries, prog, vecs, args[4], 0, **kw)
    copy = lambda s: type(s)(*(a.clone() for a in s))  # noqa: E731
    state = persistent_multi_step_plain(*args, copy(fresh), 10 ** 6, None,
                                        steps=4, **kw)
    for f in state._fields:
        getattr(state, f)[3::4] = getattr(fresh, f)[3::4]
    state.cand_dist[1::4] = INF
    state.cand_idx[1::4] = -1
    state.cand_exp[1::4] = False
    state.cand_valid[1::4] = False
    state.res_dist[1::4] = INF
    state.res_idx[1::4] = -1
    state.visited[2::4] = -1
    for steps in (1, 8, 40):
        got = persistent_multi_step(*args, copy(state), 10 ** 6, None,
                                    steps=steps, **kw)
        want = persistent_multi_step_plain(*args, copy(state), 10 ** 6, None,
                                           steps=steps, **kw)
        torch.cuda.synchronize()
        for name, g, w in zip(got._fields, state_to_numpy(got),
                              state_to_numpy(want)):
            np.testing.assert_array_equal(g, w, f"steps={steps}: {name}")
    cd = state_to_numpy(want)[0]
    with np.errstate(invalid="ignore"):  # inf - inf pads
        assert (np.diff(cd[0::4], axis=1) == 0).any(), "no ties"


# ---------------------------------------------------------------- K7 ----
def _merge_inputs(rng, b, m, r, ties: bool):
    """A sorted [b, m] buffer with +inf tails (payload -1 there) and raw
    [b, r] entries. ties=True draws integer distances, so equal keys fall
    within the new entries, within the old ones and across the two."""
    draw = ((lambda shape: rng.integers(0, 6, shape).astype(np.float32))
            if ties else (lambda shape: rng.random(shape).astype(np.float32)))
    dist = np.sort(draw((b, m)), axis=1)
    dist[:, 3 * m // 4:] = np.inf
    pay = rng.integers(0, 1 << 20, (b, m)).astype(np.int32)
    pay[np.isinf(dist)] = -1
    nd = draw((b, r))
    npay = rng.integers(0, 1 << 20, (b, r)).astype(np.int32)
    return dist, pay, nd, npay


def _stable_merge_np(dist, pay, nd, npay):
    d = np.concatenate([dist, nd], axis=1)
    p = np.concatenate([pay, npay], axis=1)
    order = np.argsort(d, axis=1, kind="stable")[:, :dist.shape[1]]
    return np.take_along_axis(d, order, axis=1), np.take_along_axis(
        p, order, axis=1)


@pytest.mark.parametrize("b,m,r", [(6, 32, 16), (4, 512, 32), (3, 40, 1),
                                   (2, 100, 160)])
@pytest.mark.parametrize("ties", [True, False])
def test_topm_merge_plain_matches_reference_host(b, m, r, ties):
    """K7's plain version (and its CPU wrapper) == the reference's
    `ops.queue_merge` host path, a stable argsort over [old | new]: ties
    within new, within old and across both included, R=1, and an M that
    is not a power of two."""
    import jax.numpy as jnp

    from repro.kernels import ops as jops

    rng = np.random.default_rng(b * 1000 + m + r)
    dist, pay, nd, npay = _merge_inputs(rng, b, m, r, ties)
    wd, wp = jops.queue_merge(*(jnp.asarray(a) for a in (dist, pay, nd,
                                                         npay)))
    args = [torch.from_numpy(a) for a in (dist, pay, nd, npay)]
    for fn in (topm_merge_plain, topm_merge, ops.queue_merge):
        gd, gp = fn(*args)
        np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    sd, sp = _stable_merge_np(dist, pay, nd, npay)
    np.testing.assert_array_equal(gd.numpy(), sd)
    np.testing.assert_array_equal(gp.numpy(), sp)
    if ties:
        with np.errstate(invalid="ignore"):  # inf - inf tails
            assert (np.diff(sd, axis=1) == 0).any(), "no ties exercised"


def test_topm_merge_plain_matches_reference_kernel_interpret():
    """K7's plain version == the reference kernel body in interpret mode,
    at a width XLA:CPU compiles (its unrolled network blows up beyond).
    Keys are distinct: the reference kernel's network breaks ties by no
    position, so on ties its payload order is not a stable one."""
    import jax.numpy as jnp

    from repro.kernels.topk import topm_merge as j_topm_merge

    rng = np.random.default_rng(3)
    dist, pay, nd, npay = _merge_inputs(rng, 4, 8, 4, ties=False)
    wd, wp = j_topm_merge(*(jnp.asarray(a) for a in (dist, pay, nd, npay)),
                          interpret=True)
    gd, gp = topm_merge_plain(*(torch.from_numpy(a)
                                for a in (dist, pay, nd, npay)))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))


def _topm_by_rank(dist, pay, nd, npay, vec):
    """A torch transcription of `csrc/topk.cu` (K7) for lanes [B, ...]:
    one block a lane of `threads` threads (the wider of ⌈M / V⌉ buffer
    loads and R new entries, rounded up to a warp, at most 1024); thread j
    loads buffer entries (j + g·threads)·V + v for g < 4, v < V (V = 4 by
    vectors, else 1) and takes new entry j; the new run ranked by
    (key, position), new entry r of rank s placed at s + #{old <= key},
    old entry i at i + #{new < d_i}, each written when below M. Returns
    (dist, payload, how many times each output slot was written, how many
    times each buffer entry was loaded)."""
    b, m = dist.shape
    r = nd.shape[1]
    v = 4 if vec else 1
    threads = min(max(-(-max(-(-m // v), r) // 32) * 32, 32), 1024)
    loaded = torch.zeros(m, dtype=torch.int64)
    for j in range(threads):
        for g in range(4):
            i = (j + g * threads) * v
            if i < m:
                loaded[i:i + v] += 1
    pos = torch.arange(r)
    before = pos[:, None] < pos[None, :]  # entry j before entry r
    kj, kk = nd[:, :, None], nd[:, None, :]
    s = ((kj < kk) | ((kj == kk) & before)).sum(1)  # [B, R]
    new_sorted = torch.full_like(nd, float("inf")).scatter(1, s, nd)
    out_d = torch.full((b, m), float("nan"))
    out_p = torch.full((b, m), -7, dtype=torch.int32)
    hits = torch.zeros((b, m), dtype=torch.int64)
    for o, keys, pays in (
            (s + torch.searchsorted(dist, nd, right=True), nd, npay),
            (torch.arange(m) + torch.searchsorted(new_sorted, dist), dist,
             pay)):
        sel = o < m
        lane = torch.arange(b)[:, None].expand_as(o)[sel]
        out_d[lane, o[sel]] = keys[sel]
        out_p[lane, o[sel]] = pays[sel]
        hits.index_put_((lane, o[sel]), torch.ones_like(lane),
                        accumulate=True)
    return out_d, out_p, hits, loaded


@pytest.mark.parametrize("m", [40, 500, 512])
@pytest.mark.parametrize("r", [1, 32, 160])
def test_topm_merge_by_rank_equals_merge_stable(m, r):
    """K7's merge by rank (`_topm_by_rank`, both load routes) ==
    `topm_merge_plain` (a stable argsort over [old | new]) under heavy
    ties, with +inf tails in both runs (an all-inf new run and an all-inf
    buffer included): every output slot written once, every buffer entry
    loaded once."""

    @settings(max_examples=25, deadline=None)
    @given(seed=st.integers(0, 2 ** 31 - 1), n_vals=st.integers(1, 4),
           old_frac=st.integers(0, 4), new_inf=st.integers(0, 4))
    def check(seed, n_vals, old_frac, new_inf):
        rng = np.random.default_rng(seed)
        b = 3
        vals = np.sort(rng.choice([0.0, 0.25, 0.5, 1.0, 2.5, 7.0], n_vals,
                                  replace=False)).astype(np.float32)
        dist = np.full((b, m), np.inf, np.float32)
        fq = m * old_frac // 4
        dist[:, :fq] = np.sort(rng.choice(vals, (b, fq)), axis=1)
        pay = np.where(np.isinf(dist), -1,
                       rng.integers(0, 1 << 29, (b, m))).astype(np.int32)
        nd = rng.choice(vals, (b, r)).astype(np.float32)
        nd[rng.random((b, r)) < new_inf / 4] = np.inf
        npay = rng.integers(0, 1 << 29, (b, r)).astype(np.int32)
        args = [torch.from_numpy(a) for a in (dist, pay, nd, npay)]
        wd, wp = topm_merge_plain(*args)
        for vec in ({False, m % 4 == 0}):
            gd, gp, hits, loaded = _topm_by_rank(*args, vec)
            assert (hits == 1).all() and (loaded == 1).all()
            assert torch.equal(gd, wd) and torch.equal(gp, wp)

    check()


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,r", [(64, 512, 32), (8, 40, 1), (5, 100, 160),
                                   (64, 500, 32), (64, 512, 1)])
def test_topm_merge_kernel_matches_plain_on_cuda(b, m, r):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel K7 has no CPU mode)")
    rng = np.random.default_rng(m + r)
    for ties in (True, False):
        args = [torch.from_numpy(a).cuda()
                for a in _merge_inputs(rng, b, m, r, ties)]
        gd, gp = topm_merge(*args)
        wd, wp = topm_merge_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(gd, wd) and torch.equal(gp, wp)


@pytest.mark.cuda
@pytest.mark.parametrize("m,r,shift", [(512, 32, 1), (42, 32, 0),
                                       (4096, 1024, 1), (16384, 64, 0)])
def test_topm_merge_kernel_load_routes_match_plain_on_cuda(m, r, shift):
    """Both of K7's buffer load routes == `topm_merge_plain`: by 4-byte
    loads (a buffer `shift` floats off 16-byte alignment, or M % 4 != 0)
    and by 16-byte vectors, up to the widest M and R a block takes; one
    wider raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel K7 has no CPU mode)")
    rng = np.random.default_rng(m + shift)
    for ties in (True, False):
        dist, pay, nd, npay = _merge_inputs(rng, 4, m, r, ties)
        # contiguous, `shift` elements off 16-byte alignment
        old = [torch.empty((4 * m + shift,), dtype=a.dtype, device="cuda")
               [shift:].view(4, m).copy_(a)
               for a in (torch.from_numpy(dist), torch.from_numpy(pay))]
        args = [*old, torch.from_numpy(nd).cuda(),
                torch.from_numpy(npay).cuda()]
        gd, gp = topm_merge(*args)
        wd, wp = topm_merge_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(gd, wd) and torch.equal(gp, wp)
    wide = (torch.zeros((1, 8), device="cuda"),
            torch.zeros((1, 8), dtype=torch.int32, device="cuda"),
            torch.zeros((1, 1025), device="cuda"),
            torch.zeros((1, 1025), dtype=torch.int32, device="cuda"))
    with pytest.raises(ValueError, match="does not take"):
        topm_merge(*wide)


# ------------------------------------------------------- K6 row ids ----
def test_sqdist_rows_plain_matches_reference_scan_lanes():
    """K6's row-id plain version == the reference's per-lane scan path
    (`scan_sqdist_lanes`) on the gathered rows; +inf where masked; V off
    SCAN_ALIGN raises in both, and ids not shaped like the mask raise."""
    import jax.numpy as jnp

    from repro.kernels.distance import scan_sqdist_lanes as j_lanes

    rng = np.random.default_rng(5)
    n, d, b, v = 700, 24, 5, 2 * SCAN_ALIGN
    base = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    ids = rng.integers(0, n, (b, v)).astype(np.int32)
    mask = rng.random((b, v)) < 0.7
    want = np.asarray(j_lanes(jnp.asarray(q), jnp.asarray(base[ids]),
                              jnp.asarray(mask)))
    got = sqdist_rows(*(torch.from_numpy(a) for a in (q, base, ids, mask)))
    assert np.isinf(got.numpy()[~mask]).all()
    np.testing.assert_allclose(got.numpy()[mask], want[mask], rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="differ in shape"):
        sqdist_rows_plain(*(torch.from_numpy(a) for a in (
            q, base, ids[0], mask)))
    with pytest.raises(ValueError, match="SCAN_ALIGN"):
        sqdist_rows(*(torch.from_numpy(a) for a in (
            q, base, ids[:, :SCAN_ALIGN + 1], mask[:, :SCAN_ALIGN + 1])))


def _rows_by_bucket(q, base, ids, mask, g, rng):
    """A torch transcription of `csrc/sqdist.cu`'s row-id variant with
    lanes in groups of g: count the unmasked (lane group, row) pairs into
    groups·N bins, scan them, place each pair's flat output index in its
    bin in a random order (the kernel's atomic cursor), then walk every bin
    that has pairs: its row once, each pair's distance alone, by the plain
    arithmetic. Returns the [B, V] output (+inf where masked) and how many
    times each position was written."""
    b, v = mask.shape
    n, d = base.shape
    groups = -(-b // g)
    lane = torch.arange(b)[:, None].expand(b, v)
    key = ((lane // g) * n + ids.long())[mask]
    flat = torch.arange(b * v).reshape(b, v)[mask]
    counts = torch.bincount(key, minlength=groups * n)
    ends = torch.zeros(groups * n + 1, dtype=torch.int64)
    ends[1:] = torch.cumsum(counts, 0)  # bin k: pairs[ends[k]:ends[k + 1]]
    perm = torch.from_numpy(rng.permutation(key.numel()))
    pairs = flat[perm[torch.argsort(key[perm], stable=True)]]
    out = torch.full((b * v,), INF)
    hits = torch.zeros(b * v, dtype=torch.int64)
    for k in torch.nonzero(counts)[:, 0].tolist():
        grp, row = divmod(k, n)
        po = pairs[ends[k]:ends[k + 1]]
        pl = po // v
        assert (pl // g == grp).all()
        x = base[row].expand(po.numel(), 1, d)
        out[po] = sqdist_bdrd(q[pl], x)[:, 0]
        hits[po] += 1
    return out.reshape(b, v), hits.reshape(b, v)


def _rows_case(rng, layout, b, v, n, d, dead):
    """Row-id inputs on the 1/8 grid (every distance exact in float32):
    layout 0 random unsorted ids with duplicates, 1 the scan's (each lane's
    passing rows ascending, padded with row 0 behind a masked tail), 2 the
    oracle's (ids c .. c+V clamped to N-1 in every lane, an interleaved
    mask); the first `dead` lanes pass no row."""
    base = np.clip(np.round(rng.normal(size=(n, d)) * 4) / 8, -2, 2)
    q = np.clip(np.round(rng.normal(size=(b, d)) * 4) / 8, -2, 2)
    if layout == 0:
        ids = rng.integers(0, n, (b, v))
        ids[:, 1::7] = ids[:, ::7][:, :ids[:, 1::7].shape[1]]
        mask = rng.random((b, v)) < 0.7
    elif layout == 1:
        ids = np.zeros((b, v), np.int64)
        mask = np.zeros((b, v), bool)
        for i in range(b):
            rows = np.flatnonzero(rng.random(n) < rng.random())[:v]
            ids[i, :rows.size] = rows
            mask[i, :rows.size] = True
    else:
        c = int(rng.integers(0, n))
        ids = np.minimum(np.arange(c, c + v), n - 1)[None].repeat(b, 0)
        mask = ((rng.random((b, v)) < rng.random((b, 1)))
                & (np.arange(c, c + v) < n)[None])
    mask[:dead] = False
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt))  # noqa: E731
    return (t(q, np.float32), t(base, np.float32), t(ids, np.int32),
            t(mask, bool))


def test_sqdist_rows_bucket_walk_equals_plain():
    """The row-id kernel's algorithm (`_rows_by_bucket`: bins by (lane
    group, row), each row read once per group) == `sqdist_rows_plain` bit
    for bit, every unmasked position written once and no masked one: random
    unsorted ids with duplicates, the scan's and the oracle's layouts,
    lanes with no passing row, more lanes than a group holds, and d not a
    multiple of 32."""

    @settings(max_examples=40, deadline=None)
    @given(seed=st.integers(0, 2 ** 31 - 1), layout=st.integers(0, 2),
           b=st.integers(1, 9), g=st.integers(1, 4), di=st.integers(0, 2),
           vi=st.integers(1, 2), dead=st.integers(0, 2))
    def check(seed, layout, b, g, di, vi, dead):
        rng = np.random.default_rng(seed)
        d, v = (24, 40, 96)[di], vi * SCAN_ALIGN
        n = int(rng.integers(v // 2, 3 * v))
        q, base, ids, mask = _rows_case(rng, layout, b, v, n, d,
                                        min(dead, b))
        got, hits = _rows_by_bucket(q, base, ids, mask, g, rng)
        assert torch.equal(hits, mask.long())
        assert torch.equal(got, sqdist_rows_plain(q, base, ids, mask))

    check()


@pytest.mark.parametrize("layout", [0, 1, 2])
def test_sqdist_rows_bucket_walk_matches_reference_scan_lanes(layout):
    """On grid data, `_rows_by_bucket` == the reference's
    `scan_sqdist_lanes` on the gathered rows, bit for bit, with 11 lanes in
    groups of 4 and d=40."""
    import jax.numpy as jnp

    from repro.kernels.distance import scan_sqdist_lanes as j_lanes

    rng = np.random.default_rng(20 + layout)
    q, base, ids, mask = _rows_case(rng, layout, 11, 2 * SCAN_ALIGN, 300,
                                    40, 1)
    got, _ = _rows_by_bucket(q, base, ids, mask, 4, rng)
    want = np.asarray(j_lanes(jnp.asarray(q.numpy()),
                              jnp.asarray(base.numpy()[ids.numpy()]),
                              jnp.asarray(mask.numpy())))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["batched_sqdist", "masked_scan_dist",
                                  "fused_traversal_step",
                                  "estimator_predict"])
def test_ops_dispatch_matches_reference_ops(name):
    """Each dispatcher of `kernels/ops.py` on CPU tensors == the
    reference's `repro.kernels.ops` function of the same name on the same
    inputs (`queue_merge` is held to it in the K7 tests above): exact on
    grid distances, the step's tolerance otherwise."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops

    rng = np.random.default_rng(11)
    t = torch.from_numpy
    if name == "batched_sqdist":
        q, x, mask = _sqdist_inputs(rng, 5, 17, 40, grid=True)
        for m in (mask, None):
            got = ops.batched_sqdist(t(q), t(x), None if m is None else t(m))
            want = jops.batched_sqdist(jnp.asarray(q), jnp.asarray(x),
                                       None if m is None else jnp.asarray(m))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    elif name == "masked_scan_dist":
        n, d, b, v = 300, 24, 4, 2 * SCAN_ALIGN
        base = np.round(rng.normal(size=(n, d)) * 64).astype(np.float32) / 64
        q = np.round(rng.normal(size=(b, d)) * 64).astype(np.float32) / 64
        ids = rng.integers(0, n, (b, v)).astype(np.int32)
        mask = rng.random((b, v)) < 0.6
        got = ops.masked_scan_dist(t(q), t(base), t(ids), t(mask))
        want = jops.masked_scan_dist(jnp.asarray(q), jnp.asarray(base[ids]),
                                     jnp.asarray(mask))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    elif name == "fused_traversal_step":
        a = _inputs(rng, 4, 32, 8, 5, 12)
        for pre in (False, True):
            got = [z.numpy() for z in ops.fused_traversal_step(
                *_torch_args(a), pre=pre)]
            _assert_step_equal(got, jops.fused_traversal_step(
                *_jax_args(a), pre=pre))
    else:
        from repro.core.gbdt import train_gbdt as j_train_gbdt

        x, model = _forest(7, 64, 8, 20, 3, j_train_gbdt)
        port = gbdt_from_arrays(model.feat, model.thresh, model.leaf,
                                model.base, model.depth)
        got = ops.estimator_predict(t(x), port.packed("cpu"), 3).numpy()
        want = jops.estimator_predict(jnp.asarray(x), (
            jnp.asarray(model.feat), jnp.asarray(model.thresh),
            jnp.asarray(model.leaf), model.base), 3)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.cuda
def test_sqdist_rows_kernel_matches_plain_on_cuda():
    """The row-id kernel against its plain version (rtol 1e-5; equal on
    grid data) and against the gathered K6 on the same rows (bitwise),
    one lane alone against the batch (bitwise), V against V + 64 padded
    rows (bitwise) and the lanes in another order (bitwise). Random,
    unsorted ids with duplicates; at B=130, d=768 (three lane groups) an N
    that is a multiple of no tile, rows that no lane passes and lanes that
    pass no row. An unmasked id outside [0, N) gives NaN."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel K6 has no CPU mode)")
    rng = np.random.default_rng(6)
    for n, d, b, v in ((5000, 96, 6, 4 * SCAN_ALIGN),
                       (4099, 768, 130, 2 * SCAN_ALIGN)):
        for grid in (True, False):
            base = rng.standard_normal((n, d))
            q = rng.standard_normal((b, d))
            if grid:
                base, q = (np.clip(np.round(a * 4) / 8, -2, 2)
                           for a in (base, q))
            ids = rng.integers(0, n - n // 5, (b, v)).astype(np.int32)
            ids[:, 1::5] = ids[:, ::5][:, :ids[:, 1::5].shape[1]]
            mask = rng.random((b, v)) < 0.7
            mask[[1, b - 1]] = False
            qt, bt, it, mt = (torch.from_numpy(np.ascontiguousarray(a)).cuda()
                              for a in (q.astype(np.float32),
                                        base.astype(np.float32), ids, mask))
            got = sqdist_rows(qt, bt, it, mt)
            want = sqdist_rows_plain(qt, bt, it, mt)
            gathered = sqdist_masked(qt, bt[it.long()], mt)
            one = sqdist_rows(qt[2:3], bt, it[2:3], mt[2:3])
            wide = sqdist_rows(qt, bt, torch.cat([it, it[:, :SCAN_ALIGN]], 1),
                               torch.cat([mt, mt[:, :SCAN_ALIGN]], 1))
            perm = torch.from_numpy(rng.permutation(b)).cuda()
            moved = sqdist_rows(qt[perm], bt, it[perm], mt[perm])
            torch.cuda.synchronize()
            assert torch.equal(torch.isinf(got), ~mt)
            if grid:
                assert torch.equal(got, want)
            else:
                assert torch.allclose(got[mt], want[mt], rtol=1e-5, atol=0.0)
            assert torch.equal(got, gathered)
            assert torch.equal(one[0], got[2])
            assert torch.equal(wide[:, :v], got)
            assert torch.equal(moved, got[perm])
    bad = it[:1].clone()
    bad[0, :2] = torch.tensor([-1, n], dtype=torch.int32)
    out = sqdist_rows(qt[:1], bt, bad, torch.ones_like(mt[:1]))
    assert torch.isnan(out[0, :2]).all() and not torch.isnan(out[0, 2:]).any()


# ------------------------------------------------------------- build ----
def test_build_target_hashes_shared_headers(tmp_path, monkeypatch):
    """A library's name covers every csrc/*.cuh, so an edited header
    builds anew instead of loading a stale library."""
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._target("k")
    assert _build._target("k") == first
    (tmp_path / "common.cuh").write_text("// v2\n")
    second = _build._target("k")
    assert second != first
    (tmp_path / "other.cuh").write_text("")
    assert _build._target("k") not in (first, second)
