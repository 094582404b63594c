"""Sorted-buffer helpers: payload packing, the plain stable top-m merge,
and kernel K7.

Counterpart of `repro/kernels/topk.py`'s `pack_payload`/`unpack_payload`
and of the order its host merge (`bitonic_merge_sorted`, position lane)
and the dense backend's stable argsort both give: entries ordered by
(distance, position in `[old | new]`). The fused kernel (K1) sorts on the
same pair, so all three agree on ties. `bitonic_merge_phase` is the
reference's compare-exchange network on (key, position) as torch ops,
the pairwise pool merge of the mesh path (`distributed.merge`); it is
jnp in the reference and no kernel here.

`topm_merge` is K7, a wrapper over `csrc/topk.cu`, with its plain version
`topm_merge_plain`. It replaces the TPU kernel
`repro/kernels/topk.py::_merge_kernel` (`topm_merge`), which only
`kernels/ops.py::queue_merge` reaches. A merge by rank: it relies on the
buffer being sorted ascending, `queue_merge`'s stated contract. One block
a lane loads both runs in one round (the buffer by 16-byte vectors where
it is aligned), ranks the new run by warp shuffles and scatters both runs
from registers after one barrier; bound on an H100 by that latency, not
bytes (see the note in `csrc/topk.cu`). On CPU tensors the wrapper runs
the plain version; on CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build


def pack_payload(idx: torch.Tensor, expanded: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """node id (< 2^29) + expanded/valid flags into one non-negative int32."""
    p = (idx | (expanded.to(torch.int32) << 29)
         | (valid.to(torch.int32) << 30))
    return torch.where(idx < 0, -1, p).to(torch.int32)


def unpack_payload(p: torch.Tensor):
    neg = p < 0
    idx = torch.where(neg, -1, p & ((1 << 29) - 1)).to(torch.int32)
    expanded = ~neg & (((p >> 29) & 1) != 0)
    valid = ~neg & (((p >> 30) & 1) != 0)
    return idx, expanded, valid


def merge_stable(dist: torch.Tensor, lanes: tuple, new_dist: torch.Tensor,
                 new_lanes: tuple, m: int):
    """Merge sorted [B, M0] (dist + value lanes) with raw [B, R] entries and
    keep the best m, in stable-argsort order over `[old | new]`.

    Returns (dist [B, m], tuple of lanes [B, m]).
    """
    d = torch.cat([dist, new_dist], dim=1)
    order = torch.argsort(d, dim=1, stable=True)[:, :m]
    out = tuple(torch.gather(torch.cat([a, b], dim=1), 1, order)
                for a, b in zip(lanes, new_lanes))
    return torch.gather(d, 1, order), out


def bitonic_merge_phase(keys: torch.Tensor, pos: torch.Tensor, lanes: tuple):
    """One full bitonic merge phase (strides w/2 … 1, all ascending) over
    a row-bitonic [B, w] block (w a power of two) under the lexicographic
    total order (key, pos); `lanes` are extra [B, w] tensors riding the
    same selects. Returns (keys, pos, lanes).

    The reference's `repro/kernels/topk.py::bitonic_merge_phase` as torch
    ops: a compare-exchange network that moves values and computes none.
    With distinct positions in a row the order is total, which is what
    makes the cross-shard merge (`distributed.merge`) independent of the
    merge tree's shape, bit for bit."""
    b, w = keys.shape
    j = w // 2
    while j >= 1:
        shape = (b, w // (2 * j), 2, j)
        kk, pp = keys.reshape(shape), pos.reshape(shape)
        lo_k, hi_k = kk[:, :, 0], kk[:, :, 1]
        lo_p, hi_p = pp[:, :, 0], pp[:, :, 1]
        keep = (lo_k < hi_k) | ((lo_k == hi_k) & (lo_p <= hi_p))

        def exchange(x):
            x = x.reshape(shape)
            lo, hi = x[:, :, 0], x[:, :, 1]
            return torch.stack([torch.where(keep, lo, hi),
                                torch.where(keep, hi, lo)],
                               dim=2).reshape(b, w)

        keys, pos = exchange(keys), exchange(pos)
        lanes = tuple(exchange(x) for x in lanes)
        j //= 2
    return keys, pos, lanes


def topm_merge_plain(dist: torch.Tensor, payload: torch.Tensor,
                     new_dist: torch.Tensor, new_payload: torch.Tensor):
    """Plain version of K7: sorted [B, M] (dist, payload) + raw [B, R]
    entries -> the best M, in stable-argsort order over `[old | new]`."""
    d, (p,) = merge_stable(dist, (payload,), new_dist, (new_payload,),
                           dist.shape[1])
    return d, p


def _lib() -> ctypes.CDLL:
    lib = _build.load("topk")
    fn = lib.topm_merge_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        sm = lib.topm_merge_smem_bytes
        sm.argtypes, sm.restype = [ctypes.c_int] * 3, ctypes.c_size_t
    return lib


@functools.lru_cache(maxsize=None)
def _smem_bytes(m: int, r: int, vec: bool) -> int:
    """The kernel's shared memory at these widths (0: a block cannot take
    them), asked of the library once per shape."""
    return _lib().topm_merge_smem_bytes(m, r, int(vec))


def topm_merge(dist: torch.Tensor, payload: torch.Tensor,
               new_dist: torch.Tensor, new_payload: torch.Tensor):
    """K7: dist [B, M] f32 sorted ascending + payload [B, M] i32, new_dist
    [B, R] f32 + new_payload [B, R] i32 (any order, no NaN) -> the best M
    (dist [B, M], payload [B, M]) of `[old | new]`, ties in stable order.

    The buffer must be sorted ascending: the kernel merges by rank and
    does not check it."""
    if dist.device.type == "cpu":
        return topm_merge_plain(dist, payload, new_dist, new_payload)
    if dist.device.type != "cuda":
        raise ValueError(f"topm_merge runs on CUDA or CPU, not {dist.device}")
    b, m = dist.shape
    r = new_dist.shape[1]
    f32, i32 = torch.float32, torch.int32
    _build.check_tensors("topm_merge", dist.device, (
        (dist, "dist", f32, (b, m)), (payload, "payload", i32, (b, m)),
        (new_dist, "new_dist", f32, (b, r)),
        (new_payload, "new_payload", i32, (b, r))))
    # the buffer goes by 16-byte vectors where both its rows and pointers
    # allow
    vec = m % 4 == 0 and (dist.data_ptr() | payload.data_ptr()) % 16 == 0
    if _smem_bytes(m, r, vec) == 0:
        raise ValueError(f"topm_merge does not take M={m}, R={r} in one "
                         f"block: R <= 1024, M <= 4096 (16384 where the "
                         f"buffer is 16-byte aligned and M % 4 == 0)")
    od = torch.empty((b, m), dtype=f32, device=dist.device)
    op = torch.empty((b, m), dtype=i32, device=dist.device)
    stream = torch.cuda.current_stream(dist.device).cuda_stream
    topm_merge.launches += 1
    err = _lib().topm_merge_f32(dist.data_ptr(), payload.data_ptr(),
                                new_dist.data_ptr(), new_payload.data_ptr(),
                                od.data_ptr(), op.data_ptr(), b, m, r,
                                int(vec), stream)
    _build.check(err, "topk")
    return od, op


topm_merge.launches = 0  # kernel launches since the last reset
