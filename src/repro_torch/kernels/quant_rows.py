"""K6q rows: compressed squared L2 by row id — wrapper over
`csrc/quant_rows.cu` and its plain PyTorch version.

The distance of the quantized scan plan (`core/plans.py::scan_search` on
an int8 or PQ engine) and of the compressed oracle
(`index/bruteforce.py::compressed_filtered_topk`): for each lane's prepared
query (`Int8Prep` or `PQPrep`) and each row id of ids [B, V] into the code
store, the ADC distance, +inf where the mask is false. It has no TPU
kernel to replace: the reference computes it in jnp over a gathered
[B, V, S·L | d] block of codes (`repro/core/plans.py:152-161`), which at
N=1M, B=64, V=2^18 is 9.7 GB of PQ codes (12.9 GB int8) before widening.
The kernel reads each row by id instead, as K6's row-id variant
(`kernels.distance.sqdist_rows`) does for float32.

On the card each pair gets the bits of the traversal's kernels: the int8
head of K3 and K5 (`step_common.cuh::row_int8_dist`) and the PQ head of K4
and K5 (`pq_head`'s slot-order sum). The plain version
`sqdist_rows_quant_plain` computes the same values: `adc_int8` (an exact
integer dot, the same float tail) and a float32 sum of the lookups in slot
order 0..S·L−1, so kernel and plain agree bit for bit under both codecs;
lane by lane, in chunks of `_PLAIN_ROWS`, so a (query, row) pair's value
depends neither on the lanes beside it nor on the padded width. Bound on
an H100: bytes (codes and norms of the unmasked pairs, each PQ lane's
table once). The PQ kernel lists each lane's unmasked positions first
(a count and a compaction launch), then one block an SM sums an equal
share of them in work items (`pq_work_items`), each reading its lane's
table once; see the note in `csrc/quant_rows.cu`. On CPU tensors the
wrapper runs the plain version; on CUDA tensors it launches the kernel
or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import MAX_SMEM_BYTES
from repro_torch.kernels.distance import _PLAIN_ROWS
from repro_torch.quant.codecs import (Int8Prep, PQPrep, _pq_assemble,
                                      adc_int8)

INF = float("inf")
PREC_IDS = {"int8": 1, "pq": 2}  # quant_rows_smem_bytes's `prec`
PQ_SEG_ROWS = 16384  # csrc/quant_rows.cu::kSegRows: rows of a work item
PQ_LANE_ROWS = 256   # csrc/quant_rows.cu::kSegLaneRows: a table's weight
PQ_TILE = 4096       # csrc/quant_rows.cu::kCompactTile: a compaction block's


def pq_grid(device) -> int:
    """Blocks of the PQ sum: one an SM of `device`."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def pq_work_items(counts, grid: int, seg_rows: int = PQ_SEG_ROWS,
                  lane_rows: int = PQ_LANE_ROWS) -> list:
    """The PQ sum's work items, as `csrc/quant_rows.cu::Walk` cuts them:
    the lanes laid end to end by weight (lane_rows for its table, then
    its unmasked positions, counts [B]; an empty lane weighs nothing),
    block i's share [T·i // grid, T·(i + 1) // grid) of the total weight
    T cut at lane boundaries into pieces of rows, each piece into
    ⌈rows / seg_rows⌉ near-equal parts. Returns (block, lane, k0, k1) for
    each item, rows k0..k1 − 1 of the lane's list; each item reads the
    lane's whole table once."""
    weight = [n + lane_rows if n else 0 for n in counts]
    total, items = sum(weight), []
    for i in range(grid):
        start, end = total * i // grid, total * (i + 1) // grid
        off = 0
        for lane, n in enumerate(counts):
            if off >= end:
                break
            r0 = off + lane_rows
            lo, hi = max(start, r0), min(end, r0 + n)
            if hi > lo:
                plo, plen = lo - r0, hi - lo
                parts = -(-plen // seg_rows)
                items += [(i, lane, plo + plen * j // parts,
                           plo + plen * (j + 1) // parts)
                          for j in range(parts)]
            off += weight[lane]
    return items


def _precision(prep) -> str:
    if isinstance(prep, Int8Prep):
        return "int8"
    if isinstance(prep, PQPrep):
        return "pq"
    raise TypeError(f"expected Int8Prep or PQPrep, got {type(prep).__name__}")


def _pq_slot_order(lane: PQPrep, codes_g: torch.Tensor,
                   norms_g: torch.Tensor) -> torch.Tensor:
    """One lane's PQ distances to rows codes_g [c, S·L]: the lookups summed
    in float32 in slot order, ((0 + lut[0, c_0]) + lut[1, c_1]) + …, then
    the ADC tail."""
    vals = torch.gather(lane.lut[0], 1, codes_g.T.long())      # [S·L, c]
    ip = torch.zeros(codes_g.shape[0], dtype=torch.float32,
                     device=codes_g.device)
    for j in range(vals.shape[0]):
        ip = ip + vals[j]
    return _pq_assemble(lane, norms_g[None], ip[None])[0]


def sqdist_rows_quant_plain(prep, codes: torch.Tensor, norms: torch.Tensor,
                            ids: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """Plain version of K6q rows: prep Int8Prep | PQPrep ([B] lanes),
    codes [N, d] int8 | [N, S·L] uint8, norms [N] f32, ids [B, V] int32,
    mask [B, V] bool -> [B, V] f32, +inf where ~mask. Lane by lane, the
    unmasked rows of each chunk of `_PLAIN_ROWS` positions gathered and
    scored: `adc_int8`, or the slot-order PQ sum. Masked ids are not read;
    an unmasked id outside [0, N) raises (or wraps, for a negative one)."""
    if ids.shape != mask.shape:
        raise ValueError(f"sqdist_rows_quant: ids {tuple(ids.shape)} and "
                         f"mask {tuple(mask.shape)} differ in shape")
    precision = _precision(prep)
    b, v = mask.shape
    out = torch.full((b, v), INF, dtype=torch.float32, device=ids.device)
    for i in range(b):
        lane = type(prep)(*(t[i:i + 1] for t in prep))
        for s in range(0, v, _PLAIN_ROWS):
            e = min(s + _PLAIN_ROWS, v)
            on = mask[i, s:e]
            rows = ids[i, s:e][on].long()
            if rows.numel() == 0:
                continue
            if precision == "int8":
                d = adc_int8(lane, codes[rows][None], norms[rows][None])[0]
            else:
                d = _pq_slot_order(lane, codes[rows], norms[rows])
            out[i, s:e][on] = d
    return out


def _lib() -> ctypes.CDLL:
    lib = _build.load("quant_rows")
    fi = lib.quant_rows_int8
    if fi.argtypes is None:
        fi.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fi.restype = ctypes.c_int
        fp = lib.quant_rows_pq
        fp.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fp.restype = ctypes.c_int
        sm = lib.quant_rows_smem_bytes
        sm.argtypes, sm.restype = [ctypes.c_int] * 3, ctypes.c_size_t
    return lib


def sqdist_rows_quant(prep, codes: torch.Tensor, norms: torch.Tensor,
                      ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """K6q rows: prep Int8Prep (qq [B, d] int8, sq [B], qn [B]) or PQPrep
    (lut [B, S·L, Kc] f32, qn [B]), codes [N, d] int8 (d a multiple of 4)
    or [N, S·L] uint8, norms [N] f32, ids [B, V] int32, mask [B, V] bool
    -> [B, V] f32 compressed squared L2 to rows codes[ids], +inf where
    masked (masked ids are not read). On the card an unmasked id outside
    [0, N) gives NaN. Under PQ one call is three kernel launches (the
    count and the compaction of the unmasked positions, then the sum),
    counted as one."""
    if ids.device.type == "cpu":
        return sqdist_rows_quant_plain(prep, codes, norms, ids, mask)
    if ids.device.type != "cuda":
        raise ValueError(f"sqdist_rows_quant runs on CUDA or CPU, not "
                         f"{ids.device}")
    precision = _precision(prep)
    dev = ids.device
    b, v = mask.shape
    n, width = codes.shape
    f32 = torch.float32
    specs = [(norms, "norms", f32, (n,)), (ids, "ids", torch.int32, (b, v)),
             (mask, "mask", torch.bool, (b, v)),
             (prep.qn, "prep.qn", f32, (b,))]
    if precision == "int8":
        if width % 4:
            raise ValueError(f"K6q rows reads int8 codes as 4-byte words; "
                             f"d={width} is not a multiple of 4")
        specs += [(codes, "codes", torch.int8, (n, width)),
                  (prep.qq, "prep.qq", torch.int8, (b, width)),
                  (prep.sq, "prep.sq", f32, (b,))]
        kc = 0
    else:
        kc = prep.lut.shape[2]
        specs += [(codes, "codes", torch.uint8, (n, width)),
                  (prep.lut, "prep.lut", f32, (b, width, kc))]
    _build.check_tensors("sqdist_rows_quant", dev, specs)
    lib = _lib()
    smem = lib.quant_rows_smem_bytes(PREC_IDS[precision], width, kc)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"sqdist_rows_quant needs {smem} B of shared memory "
                         f"(Kc={kc}); a block has {MAX_SMEM_BYTES}")
    out = torch.empty((b, v), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sqdist_rows_quant.launches[precision] += 1
    if precision == "int8":
        err = lib.quant_rows_int8(
            prep.qq.data_ptr(), prep.sq.data_ptr(), prep.qn.data_ptr(),
            codes.data_ptr(), norms.data_ptr(), ids.data_ptr(),
            mask.data_ptr(), out.data_ptr(), b, v, width, n, stream)
    else:  # the compaction's lists of unmasked positions and their ids
        cid = torch.empty((b, v), dtype=torch.int32, device=dev)
        pos = torch.empty((b, v), dtype=torch.int32, device=dev)
        cnt = torch.empty((b * (1 + -(-v // PQ_TILE)),), dtype=torch.int32,
                          device=dev)  # lanes', then tiles' counts
        err = lib.quant_rows_pq(
            prep.lut.data_ptr(), prep.qn.data_ptr(), codes.data_ptr(),
            norms.data_ptr(), ids.data_ptr(), mask.data_ptr(),
            out.data_ptr(), cid.data_ptr(), pos.data_ptr(), cnt.data_ptr(),
            b, v, width, kc, n, pq_grid(dev), stream)
    _build.check(err, "quant_rows")
    return out


# kernel launches since the last reset, per codec
sqdist_rows_quant.launches = dict.fromkeys(("int8", "pq"), 0)
