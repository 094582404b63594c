"""K5: the persistent multi-step traversal — wrapper over
`csrc/persistent_step.cu` and its plain PyTorch version.

Replaces the TPU kernel `repro/kernels/persistent_step.py::_persistent_kernel`
(post mode), its float32, int8 and PQ branches. One launch advances a
`SearchState` by up to `min(steps, rem)` lockstep steps; each step is
exactly `core/step.py::make_step` with the fused backend (pop,
neighbor-id row, visited test-before-set, filter program, distances —
K1's, K3's or K4's —, queue and result merges, lane-masked counters,
`q_err_sum`, stop and convergence tests), so the state it returns is a
step boundary of the single-step path, bit for bit.

The reference packs per-node operands for the TPU's per-row DMAs
(`build_persistent_operands`: rows padded to 128 lanes, labels, value
bits and norms in one aux row). That packing has no counterpart here: the
kernel reads each new neighbor's vector row (or codes, ADC norm and
error), label words and values straight from `base_vectors` (or the
quant index), `attrs[0]` and `attrs[1]`.

The state passed in is consumed: its visited bitset is updated in place,
as `run_search` documents. Its candidate queue and result set must be
sorted ascending (`SearchState`'s invariant): the kernel merges by rank
and does not check it. Bound on an H100: the latency of each lane's
serial step chain, not bytes or operations; the note in
`csrc/persistent_step.cu` says what the design does about it. On CPU
tensors the wrapper runs `persistent_multi_step_plain`; on CUDA tensors
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.filters.compile import CLAUSE_FEATURE_SLOTS, MAX_SLOTS
from repro_torch.kernels import _build
from repro_torch.kernels._build import MAX_SMEM_BYTES
from repro_torch.kernels.fused_step import HEAD_IDS


def _n_steps(steps: int, rem: int) -> int:
    return max(0, min(int(steps), int(rem)))


def persistent_multi_step_plain(cfg, queries, prog, base_vectors, attrs,
                                neighbors, budgets, state, rem, gt_dist, *,
                                steps: int, quant=None, qprep=None):
    """Plain version of K5: the port's plain step (the dense backend, no
    kernel inside) looped as the reference's launch loops it — at most
    `min(steps, rem)` steps, none once no lane is active."""
    from repro_torch.core.backends import get_backend
    from repro_torch.core.step import make_step

    cfg = dataclasses.replace(cfg, use_pallas=False)
    step = make_step(cfg, get_backend("dense"), queries, prog, base_vectors,
                     attrs, neighbors, budgets, gt_dist, quant=quant,
                     qprep=qprep)
    for _ in range(_n_steps(steps, rem)):
        if not bool(state.active.any()):
            break
        state = step(state)
    return state


def _lib() -> ctypes.CDLL:
    lib = _build.load("persistent_step")
    fn = lib.persistent_step_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        sm = lib.persistent_step_smem_bytes
        sm.argtypes, sm.restype = [ctypes.c_int] * 6, ctypes.c_size_t
    return lib


def _codec_operands(precision: str, quant, qprep, n: int, b: int):
    """Checks, the 7 codec pointers' tensors (codes, norms, err, qq, sq,
    qn, lut; None where the codec has none), the row width D and Kc, for
    K5's int8 and PQ branches."""
    f32 = torch.float32
    width = quant.codes.shape[1]
    specs = [(quant.norms, "quant.norms", f32, (n,)),
             (quant.err, "quant.err", f32, (n,)),
             (qprep.qn, "qprep.qn", f32, (b,))]
    if precision == "int8":
        if width % 4:
            raise ValueError(f"K5 reads int8 codes as 4-byte words; d={width}"
                             " is not a multiple of 4")
        specs += [(quant.codes, "quant.codes", torch.int8, (n, width)),
                  (qprep.qq, "qprep.qq", torch.int8, (b, width)),
                  (qprep.sq, "qprep.sq", f32, (b,))]
        ops = (quant.codes, quant.norms, quant.err, qprep.qq, qprep.sq,
               qprep.qn, None)
        return specs, ops, width, 0
    if precision == "pq":
        kc = qprep.lut.shape[2]
        specs += [(quant.codes, "quant.codes", torch.uint8, (n, width)),
                  (qprep.lut, "qprep.lut", f32, (b, width, kc))]
        ops = (quant.codes, quant.norms, quant.err, None, None, qprep.qn,
               qprep.lut)
        return specs, ops, width, kc
    raise ValueError(f"unknown precision {precision!r}")


def persistent_multi_step(cfg, queries, prog, base_vectors, attrs, neighbors,
                          budgets, state, rem: int, gt_dist, *, steps: int,
                          quant=None, qprep=None):
    """Advance `state` by up to `min(steps, rem)` lockstep steps in one
    launch (post mode).

    queries [B,d] f32, prog FilterProgram (leaves [B,S,...]), base_vectors
    [N,d] f32 (read at float32 only), attrs (labels [N,W] i32, values [N,V] f32), neighbors
    [N,R] i32, budgets [B] i32, state SearchState (consumed), gt_dist
    [B,K] f32 or None; under `cfg.precision` "int8" or "pq", quant the
    Int8Index / PQIndex and qprep its per-query state -> SearchState.
    """
    if queries.device.type == "cpu":
        return persistent_multi_step_plain(
            cfg, queries, prog, base_vectors, attrs, neighbors, budgets,
            state, rem, gt_dist, steps=steps, quant=quant, qprep=qprep)
    if queries.device.type != "cuda":
        raise ValueError(f"persistent_multi_step runs on CUDA or CPU, not "
                         f"{queries.device}")
    if cfg.mode != "post":
        raise ValueError(
            f"persistent_multi_step runs post mode, as the reference's "
            f"kernel does; mode {cfg.mode!r} launches step the fused "
            "backend (core.search.run_search_persistent)")
    precision = cfg.precision or "float32"
    dev = queries.device
    labels, values = attrs
    b, d = queries.shape
    n, r = neighbors.shape
    w, v = labels.shape[1], values.shape[1]
    m, k = state.cand_dist.shape[1], state.res_dist.shape[1]
    s, t = prog.kinds.shape[1], prog.term_active.shape[1]
    nw = (n + 31) // 32
    if s > MAX_SLOTS:
        raise ValueError(f"program has {s} clause slots; the kernel takes "
                         f"at most {MAX_SLOTS}")
    i32, f32, bl = torch.int32, torch.float32, torch.bool
    checks = [
        (queries, "queries", f32, (b, d)),
        (labels, "labels", i32, (n, w)), (values, "values", f32, (n, v)),
        (neighbors, "neighbors", i32, (n, r)),
        (prog.kinds, "prog.kinds", i32, (b, s)),
        (prog.masks, "prog.masks", i32, (b, s, w)),
        (prog.lo, "prog.lo", f32, (b, s)), (prog.hi, "prog.hi", f32, (b, s)),
        (prog.vattr, "prog.vattr", i32, (b, s)),
        (prog.neg, "prog.neg", bl, (b, s)),
        (prog.term, "prog.term", i32, (b, s)),
        (prog.active, "prog.active", bl, (b, s)),
        (prog.term_active, "prog.term_active", bl, (b, t)),
        (budgets, "budgets", i32, (b,)),
        (state.cand_dist, "cand_dist", f32, (b, m)),
        (state.cand_idx, "cand_idx", i32, (b, m)),
        (state.cand_exp, "cand_exp", bl, (b, m)),
        (state.cand_valid, "cand_valid", bl, (b, m)),
        (state.res_dist, "res_dist", f32, (b, k)),
        (state.res_idx, "res_idx", i32, (b, k)),
        (state.visited, "visited", i32, (b, nw)),
        (state.n_clause_valid, "n_clause_valid", i32,
         (b, CLAUSE_FEATURE_SLOTS)),
        (state.active, "active", bl, (b,)),
    ]
    checks += [(getattr(state, f), f, i32, (b,)) for f in (
        "cnt", "n_inspected", "n_valid_visited", "n_pop_valid", "hops",
        "conv_cnt", "res_full_cnt")]
    if gt_dist is not None:
        checks.append((gt_dist, "gt_dist", f32, (b, k)))
    prec_id = HEAD_IDS[precision]
    if precision == "float32":
        checks.append((base_vectors, "base_vectors", f32, (n, d)))
        codec, row_d, kc = (None,) * 7, d, 0
    else:
        # the codec branches read codes, never the float32 rows: a host-tier
        # or sharded engine holds only an [N, 0] placeholder there
        base_vectors = None
        specs, codec, row_d, kc = _codec_operands(precision, quant, qprep, n,
                                                  b)
        checks += specs + [(state.q_err_sum, "q_err_sum", f32, (b,))]
    _build.check_tensors("persistent_multi_step", dev, checks)
    lib = _lib()
    smem = lib.persistent_step_smem_bytes(prec_id, r, row_d, m, k, kc)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"persistent_multi_step needs {smem} B of shared memory at "
            f"d={d}, R={r}, M={m}, K={k}; a block has {MAX_SMEM_BYTES}")
    out = {f: torch.empty_like(getattr(state, f)) for f in (
        "cand_dist", "cand_idx", "cand_exp", "cand_valid", "res_dist",
        "res_idx", "cnt", "n_inspected", "n_valid_visited", "n_clause_valid",
        "n_pop_valid", "hops", "active", "conv_cnt", "res_full_cnt")}
    q_err = (state.q_err_sum if precision == "float32"
             else torch.empty_like(state.q_err_sum))
    ins = (queries, base_vectors, labels, values, neighbors, *prog, budgets,
           gt_dist, state.cand_dist, state.cand_idx, state.cand_exp,
           state.cand_valid, state.res_dist, state.res_idx, state.visited,
           state.cnt, state.n_inspected, state.n_valid_visited,
           state.n_clause_valid, state.n_pop_valid, state.hops, state.active,
           state.conv_cnt, state.res_full_cnt)
    # the 56 pointers of csrc/persistent_step.cu's PersistArgs, in order
    ptrs = [0 if a is None else a.data_ptr() for a in (
        *ins, *out.values(), *codec,
        None if precision == "float32" else state.q_err_sum,
        None if precision == "float32" else q_err)]
    dims = [b, r, row_d, m, k, w, v, s, t, nw, _n_steps(steps, rem),
            int(cfg.greedy_stop), prec_id, kc]
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_dims = (ctypes.c_int * len(dims))(*dims)
    stream = torch.cuda.current_stream(dev).cuda_stream
    persistent_multi_step.launches[precision] += 1
    err = lib.persistent_step_f32(c_ptrs, c_dims, stream)
    _build.check(err, "persistent_step")
    return state._replace(**out, q_err_sum=q_err)


# kernel launches since the last reset, per branch
persistent_multi_step.launches = dict.fromkeys(("float32", "int8", "pq"), 0)
