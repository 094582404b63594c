"""K1: the fused traversal step — wrapper over `csrc/fused_step.cu` and its
plain PyTorch version.

Replaces the TPU kernel `repro/kernels/fused_step.py::_fused_step_kernel`
(with `_merge_core`, `_program_valid_kernel` and
`kernels/topk.py::bitonic_topm`). One launch per lockstep step computes,
per query lane:

  1. the compiled filter program over the gathered label words and value
     channels, with per-clause hit counts over the first-visit neighbors;
  2. squared L2 `max(‖q‖² + ‖x‖² − 2 q·x, 0)` to the R gathered rows;
  3. the post/pre distance mask and the payload `nb | valid << 30`;
  4. the top-M queue merge and the top-K result merge, ordered by
     (distance, position in `[old | new]`) — a stable argsort's order.
     The kernel merges by rank, which relies on the old buffers being
     sorted ascending (`SearchState`'s invariant); it does not check it.

Under `precision="int8"` the same launch is K3 (replaces
`_fused_step_int8_kernel`): step 2 becomes the int8 ADC distance
`max((qn + xn) − (2·sq)·(qq · c), 0)` over the gathered int8 codes, the
dot as packed-int8 `__dp4a` words. Under `precision="pq"` it is K4
(replaces `_fused_step_pq_kernel`): `max((qn + xn) − 2·Σ lut[slot, code],
0)`, the per-lane table streamed from device memory into shared memory
by chunks of `PQ_CHUNK` rows while the previous chunk is summed, each
code row in slot order. The float vectors are not read.

Bound on an H100: bytes (the gathered rows or codes are read once); the
source note in `csrc/fused_step.cu` says what the design does about it. On
CPU tensors the wrapper runs `fused_step_plain`; on CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.filters.compile import (
    CLAUSE_FEATURE_SLOTS,
    MAX_SLOTS,
    FilterProgram,
    clause_counts,
    eval_program_gathered,
)
from repro_torch.kernels import _build
from repro_torch.kernels._build import MAX_SMEM_BYTES
from repro_torch.kernels.distance import sqdist_bdrd
from repro_torch.kernels.topk import merge_stable
from repro_torch.quant.codecs import quant_dist

INF = float("inf")
HEAD_IDS = {"float32": 0, "int8": 1, "pq": 2}  # the entry points' `prec`


def fused_step_plain(q, x, nb, is_new, prog: FilterProgram, labels_g,
                     values_g, cand_dist, cand_pay, res_dist, res_idx, *,
                     pre: bool = False, quant=None,
                     precision: str = "float32"):
    """Plain PyTorch version of K1, K3 and K4 (same signature and outputs;
    the compressed distances are `quant_dist`'s).

    Returns (cand_dist [B,M], cand_pay [B,M], res_dist [B,K],
    res_idx [B,K], valid [B,R] bool, clause_add [B,4] i32).
    """
    m, k = cand_dist.shape[1], res_dist.shape[1]
    pvalid, clause_sat = eval_program_gathered(prog, labels_g, values_g)
    valid = pvalid & is_new
    cadd = clause_counts(clause_sat, is_new)
    dmask = valid if pre else is_new
    d_raw = (sqdist_bdrd(q, x) if quant is None
             else quant_dist(precision, quant))
    dd = torch.where(dmask, d_raw, INF)
    new_pay = torch.where(dmask, nb | (valid.to(torch.int32) << 30), -1)
    ocd, (ocp,) = merge_stable(cand_dist, (cand_pay,), dd,
                               (new_pay.to(torch.int32),), m)
    take = valid & dmask
    res_in = torch.where(take, dd, INF)
    res_pay = torch.where(take, nb, -1).to(torch.int32)
    ordd, (ori,) = merge_stable(res_dist, (res_idx,), res_in, (res_pay,), k)
    return ocd, ocp, ordd, ori, valid, cadd


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_step")
    fn = lib.fused_step_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 25 + [ctypes.c_int] * 10 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fq = lib.fused_step_quant
        fq.argtypes = [ctypes.c_void_p] * 3
        fq.restype = ctypes.c_int
        sm = lib.fused_step_smem_bytes
        sm.argtypes, sm.restype = [ctypes.c_int] * 6, ctypes.c_size_t
    return lib


def _quant_head(quant, precision: str, b: int, r: int):
    """Checks and pointers of the K3/K4 distance head: (tensor specs,
    pointers codes, xn, qq|lut, sq|None, qn; codes width; Kc)."""
    u8, i8, f32 = torch.uint8, torch.int8, torch.float32
    prep = quant.prep
    width = quant.codes.shape[2]
    specs = [(quant.norms, "quant.norms", f32, (b, r)),
             (prep.qn, "prep.qn", f32, (b,))]
    if precision == "int8":
        if width % 4:
            raise ValueError(f"K3 reads int8 codes as 4-byte words; d={width}"
                             " is not a multiple of 4")
        specs += [(quant.codes, "quant.codes", i8, (b, r, width)),
                  (prep.qq, "prep.qq", i8, (b, width)),
                  (prep.sq, "prep.sq", f32, (b,))]
        return (specs, [quant.codes, quant.norms, prep.qq, prep.sq, prep.qn],
                width, 0)
    if precision == "pq":
        kc = prep.lut.shape[2]
        specs += [(quant.codes, "quant.codes", u8, (b, r, width)),
                  (prep.lut, "prep.lut", f32, (b, width, kc))]
        return (specs, [quant.codes, quant.norms, prep.lut, None, prep.qn],
                width, kc)
    raise ValueError(f"unknown precision {precision!r}")


def fused_step(q, x, nb, is_new, prog: FilterProgram, labels_g, values_g,
               cand_dist, cand_pay, res_dist, res_idx, *, pre: bool = False,
               quant=None, precision: str = "float32"):
    """One fused traversal step over a batch of lanes.

    q [B,d] f32, x [B,R,d] f32 (None in compressed mode), nb [B,R] i32,
    is_new [B,R] bool, prog FilterProgram (leaves [B,S,...]), labels_g
    [B,R,W] i32, values_g [B,R,V] f32, cand_dist [B,M] f32 + cand_pay [B,M]
    i32 (sorted ascending), res_dist [B,K] f32 + res_idx [B,K] i32, quant
    a QuantGather under precision "int8" (K3) or "pq" (K4)
    -> (cand_dist, cand_pay, res_dist, res_idx, valid [B,R] bool,
        clause_add [B,4] i32).
    """
    if nb.device.type == "cpu":
        return fused_step_plain(q, x, nb, is_new, prog, labels_g, values_g,
                                cand_dist, cand_pay, res_dist, res_idx,
                                pre=pre, quant=quant, precision=precision)
    if nb.device.type != "cuda":
        raise ValueError(f"fused_step runs on CUDA or CPU, not {nb.device}")
    dev = nb.device
    b, r = nb.shape
    m, k = cand_dist.shape[1], res_dist.shape[1]
    w, v = labels_g.shape[2], values_g.shape[2]
    s, t = prog.kinds.shape[1], prog.term_active.shape[1]
    if s > MAX_SLOTS:
        raise ValueError(f"program has {s} clause slots; the kernel takes "
                         f"at most {MAX_SLOTS}")
    i32, f32, bl = torch.int32, torch.float32, torch.bool
    compressed = precision != "float32"
    if compressed:
        head_specs, head, d, kc = _quant_head(quant, precision, b, r)
    else:
        d, kc = q.shape[1], 0
        head_specs = [(q, "q", f32, (b, d)), (x, "x", f32, (b, r, d))]
    _build.check_tensors("fused_step", dev, (
            *head_specs,
            (nb, "nb", i32, (b, r)), (is_new, "is_new", bl, (b, r)),
            (labels_g, "labels_g", i32, (b, r, w)),
            (values_g, "values_g", f32, (b, r, v)),
            (prog.kinds, "prog.kinds", i32, (b, s)),
            (prog.masks, "prog.masks", i32, (b, s, w)),
            (prog.lo, "prog.lo", f32, (b, s)), (prog.hi, "prog.hi", f32, (b, s)),
            (prog.vattr, "prog.vattr", i32, (b, s)),
            (prog.neg, "prog.neg", bl, (b, s)),
            (prog.term, "prog.term", i32, (b, s)),
            (prog.active, "prog.active", bl, (b, s)),
            (prog.term_active, "prog.term_active", bl, (b, t)),
            (cand_dist, "cand_dist", f32, (b, m)),
            (cand_pay, "cand_pay", i32, (b, m)),
            (res_dist, "res_dist", f32, (b, k)),
            (res_idx, "res_idx", i32, (b, k))))
    lib = _lib()
    smem = lib.fused_step_smem_bytes(HEAD_IDS[precision], r, d, m, k, kc)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"fused_step needs {smem} B of shared memory at d={d}, R={r}, "
            f"M={m}, K={k}; a block has {MAX_SMEM_BYTES}")
    ocd = torch.empty((b, m), dtype=f32, device=dev)
    ocp = torch.empty((b, m), dtype=i32, device=dev)
    ordd = torch.empty((b, k), dtype=f32, device=dev)
    ori = torch.empty((b, k), dtype=i32, device=dev)
    valid = torch.empty((b, r), dtype=bl, device=dev)
    counts = torch.empty((b, CLAUSE_FEATURE_SLOTS), dtype=i32, device=dev)
    tail = (nb, is_new, labels_g, values_g, *prog, cand_dist, cand_pay,
            res_dist, res_idx, ocd, ocp, ordd, ori, valid, counts)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fused_step.launches[precision] += 1
    if compressed:
        # the 28 pointers and 12 sizes of csrc/fused_step.cu's
        # fused_step_quant, in order
        ptrs = [0 if a is None else a.data_ptr() for a in (*head, *tail)]
        dims = [b, r, d, m, k, w, v, s, t, int(pre), HEAD_IDS[precision],
                kc]
        err = lib.fused_step_quant((ctypes.c_void_p * len(ptrs))(*ptrs),
                                   (ctypes.c_int * len(dims))(*dims), stream)
    else:
        ptrs = [a.data_ptr() for a in (q, x, *tail)]
        err = lib.fused_step_f32(*ptrs, b, r, d, m, k, w, v, s, t, int(pre),
                                 stream)
    _build.check(err, "fused_step")
    return ocd, ocp, ordd, ori, valid, counts


# kernel launches since the last reset, per head: "float32" (K1), "int8"
# (K3), "pq" (K4)
fused_step.launches = dict.fromkeys(("float32", "int8", "pq"), 0)
