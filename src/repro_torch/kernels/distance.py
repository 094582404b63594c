"""Squared L2: the port's one distance expression and kernel K6.

`sqdist_bdrd` is the counterpart of `repro/kernels/distance.py::sqdist_bdrd`.
`sqdist_masked` is K6, the masked batched distance — a wrapper over
`csrc/sqdist.cu` — with its plain version `sqdist_masked_plain`. It
replaces the TPU kernel `repro/kernels/distance.py::_sqdist_kernel`; the
dense backend sends its distances through it under
`SearchConfig(use_pallas=True)`. On the card it computes each (query,
row) pair in K1's order, so its distances equal the fused backend's bit
for bit. Bound on an H100: bytes (each unmasked row is read once); see
the note in `csrc/sqdist.cu`. On CPU tensors the wrapper runs the plain
version; on CUDA tensors it launches the kernel or raises.

`sqdist_rows` is K6's row-id variant, the distance of the pre-filter scan
plan and of the exact oracle (`index.bruteforce.filtered_knn_exact`): it
takes row ids into the `[N, d]` store instead of a gathered `[B, V, d]`
block, which at N=1M would not fit the card. Its plain version,
`sqdist_rows_plain`, evaluates each lane alone at the canonical
`[1, V, d]` shape (`scan_sqdist_lanes`), as the reference's host path
does, so a (query, row) pair gives the same bits whatever lanes share
the batch and however wide the padded block is. The kernel gives the same
bits by construction: it buckets the unmasked (lane, position) pairs by
(lane group, row), reads each row once per group of up to 64 lanes, and
computes each pair alone in K1's order (`csrc/sqdist.cu`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import MAX_SMEM_BYTES

INF = float("inf")

# Row-count alignment of the scan plan's distance blocks, as in the
# reference (`repro/kernels/distance.py::SCAN_ALIGN`): scan widths are
# multiples of it, so the padding a gather adds cannot change a value.
SCAN_ALIGN = 64


def sqdist_bdrd(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """q [B, d], x [B, R, d] -> [B, R] squared L2, clamped >= 0.

    `init_state`, the dense backend and the plain versions of K1, K5 and
    K6 all call this, so a numerics change cannot desynchronize them.
    """
    q = q.to(torch.float32)
    x = x.to(torch.float32)
    qn = (q * q).sum(dim=-1)[:, None]
    xn = (x * x).sum(dim=-1)
    qx = torch.einsum("bd,brd->br", q, x)
    return torch.clamp(qn + xn - 2.0 * qx, min=0.0)


def sqdist_masked_plain(q: torch.Tensor, x: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K6: +inf where ~mask."""
    return torch.where(mask, sqdist_bdrd(q, x), INF)


def scan_sqdist_lanes(q: torch.Tensor, x: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Per-lane masked squared L2: q [B, d], x [B, V, d], mask [B, V] ->
    [B, V] f32, +inf where ~mask.

    Each lane is evaluated alone at the canonical [1, V, d] shape, so a
    (query, row) pair's value does not depend on which lanes share the
    batch (`repro/kernels/distance.py::scan_sqdist_lanes`). V must be a
    multiple of SCAN_ALIGN.
    """
    if x.shape[1] % SCAN_ALIGN:
        raise ValueError(
            f"scan width {x.shape[1]} not a multiple of SCAN_ALIGN "
            f"({SCAN_ALIGN}); pad the gathered block")
    q = q.to(torch.float32)
    out = torch.empty(mask.shape, dtype=torch.float32, device=q.device)
    for i in range(q.shape[0]):
        out[i] = sqdist_bdrd(q[i:i + 1], x[i:i + 1])[0]
    return torch.where(mask, out, INF)


# rows of a lane the plain row-id version gathers at once: a multiple of
# SCAN_ALIGN, so the chunking cannot change a value
_PLAIN_ROWS = 1 << 16


def sqdist_rows_plain(q: torch.Tensor, base: torch.Tensor, ids: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Plain version of K6's row-id variant: q [B, d], base [N, d], ids
    [B, V] int32, mask [B, V] -> [B, V] f32, +inf where ~mask:
    `scan_sqdist_lanes` per lane over its gathered rows, in chunks of
    _PLAIN_ROWS."""
    b, v = mask.shape
    if ids.shape != mask.shape:
        raise ValueError(f"sqdist_rows: ids {tuple(ids.shape)} and mask "
                         f"{tuple(mask.shape)} differ in shape")
    out = torch.empty((b, v), dtype=torch.float32, device=q.device)
    for i in range(b):
        lane_ids = ids[i].long()
        for s in range(0, v, _PLAIN_ROWS):
            e = min(s + _PLAIN_ROWS, v)
            out[i, s:e] = scan_sqdist_lanes(
                q[i:i + 1], base[lane_ids[s:e]][None], mask[i:i + 1, s:e])[0]
    return out


def oracle_block(ok: torch.Tensor, c: int,
                 ce: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact oracles' layout for rows c..ce−1 of the store, given the
    validity ok [B, N]: ids [B, V] int32 — those rows, the same in every
    lane, padded to V, a multiple of SCAN_ALIGN, with row N − 1 — and mask
    [B, V], ok[:, c:ce] padded with False."""
    n = ok.shape[1]
    v = ce - c + (c - ce) % SCAN_ALIGN
    ids = torch.arange(c, c + v, dtype=torch.int32,
                       device=ok.device).clamp_(max=n - 1)
    ids = ids[None].expand(ok.shape[0], v).contiguous()  # one row per lane
    mask = torch.nn.functional.pad(ok[:, c:ce], (0, v - (ce - c)))
    return ids, mask.contiguous()


def _lib() -> ctypes.CDLL:
    lib = _build.load("sqdist")
    fn = lib.sqdist_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fr = lib.sqdist_rows_f32
        fr.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fr.restype = ctypes.c_int
        fs = lib.sqdist_rows_scratch_bytes
        fs.argtypes, fs.restype = [ctypes.c_int] * 4, ctypes.c_size_t
        sm = lib.sqdist_smem_bytes
        sm.argtypes, sm.restype = [ctypes.c_int], ctypes.c_size_t
    return lib


def _check_smem(lib, name: str, d: int) -> None:
    if lib.sqdist_smem_bytes(d) > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: d={d} needs more than {MAX_SMEM_BYTES} B "
                         "of shared memory")


def sqdist_masked(q: torch.Tensor, x: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """q [B, d] f32, x [B, R, d] f32, mask [B, R] bool -> [B, R] f32
    squared L2, +inf where masked."""
    if q.device.type == "cpu":
        return sqdist_masked_plain(q, x, mask)
    if q.device.type != "cuda":
        raise ValueError(f"sqdist_masked runs on CUDA or CPU, not {q.device}")
    b, d = q.shape
    r = x.shape[1]
    _build.check_tensors("sqdist_masked", q.device, (
        (q, "q", torch.float32, (b, d)), (x, "x", torch.float32, (b, r, d)),
        (mask, "mask", torch.bool, (b, r))))
    lib = _lib()
    _check_smem(lib, "sqdist_masked", d)
    out = torch.empty((b, r), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    sqdist_masked.launches += 1
    err = lib.sqdist_f32(q.data_ptr(), x.data_ptr(), mask.data_ptr(),
                         out.data_ptr(), b, r, d, stream)
    _build.check(err, "sqdist")
    return out


sqdist_masked.launches = 0  # kernel launches since the last reset


def sqdist_rows(q: torch.Tensor, base: torch.Tensor, ids: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """K6's row-id variant: q [B, d] f32, base [N, d] f32, ids [B, V]
    int32, mask [B, V] bool -> [B, V] f32 squared L2 to rows base[ids],
    +inf where masked (masked ids are not read). V must be a multiple of
    SCAN_ALIGN. On the card an unmasked id outside [0, N) gives NaN."""
    if q.device.type == "cpu":
        return sqdist_rows_plain(q, base, ids, mask)
    if q.device.type != "cuda":
        raise ValueError(f"sqdist_rows runs on CUDA or CPU, not {q.device}")
    b, d = q.shape
    v = mask.shape[1]
    if v % SCAN_ALIGN:
        raise ValueError(f"scan width {v} not a multiple of SCAN_ALIGN "
                         f"({SCAN_ALIGN}); pad the row ids")
    _build.check_tensors("sqdist_rows", q.device, (
        (q, "q", torch.float32, (b, d)),
        (base, "base", torch.float32, (base.shape[0], d)),
        (ids, "ids", torch.int32, (b, v)),
        (mask, "mask", torch.bool, (b, v))))
    lib = _lib()
    _check_smem(lib, "sqdist_rows", d)
    # the kernel reads ids 16 and mask 4 bytes at a time
    if ids.data_ptr() % 16:
        ids = ids.clone()
    if mask.data_ptr() % 4:
        mask = mask.clone()
    n = base.shape[0]
    out = torch.empty((b, v), dtype=torch.float32, device=q.device)
    scratch = torch.empty(lib.sqdist_rows_scratch_bytes(b, v, d, n),
                          dtype=torch.uint8, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    sqdist_rows.launches += 1
    err = lib.sqdist_rows_f32(q.data_ptr(), base.data_ptr(), ids.data_ptr(),
                              mask.data_ptr(), out.data_ptr(),
                              scratch.data_ptr(), b, v, d, n, stream)
    _build.check(err, "sqdist")
    return out


sqdist_rows.launches = 0  # kernel launches since the last reset
