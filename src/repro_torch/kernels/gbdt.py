"""K2: GBDT ensemble inference — wrapper over `csrc/gbdt.cu` and its plain
PyTorch version.

Replaces the TPU kernel `repro/kernels/gbdt.py::_gbdt_kernel`, the cost
estimator between the probe and the resumed traversal: features [B, F]
→ predictions [B] over heap-packed complete trees (`core.gbdt`). One
block per lane and one thread per tree, reading the forest where it lies
(no copy into shared memory), then a tree-order sum; bound on an H100 by
the walk's loads and the serial sum, not bytes (see the note in
`csrc/gbdt.cu`). On CPU tensors the wrapper runs `gbdt_predict_plain`; on
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import MAX_SMEM_BYTES


def gbdt_predict_plain(feats, feat, thresh, leaf, base: float,
                       depth: int) -> torch.Tensor:
    """feats [B,F] -> [B] f32; the same walk as `repro`'s `predict_jax`."""
    t, ni = feat.shape
    b = feats.shape[0]
    t_ix = torch.arange(t, device=feats.device)[None, :]
    idx = torch.zeros((b, t), dtype=torch.int64, device=feats.device)
    for _ in range(depth):
        f = feat[t_ix, idx].long()                      # [B, T]
        xv = torch.gather(feats, 1, f)
        go_left = xv <= thresh[t_ix, idx]
        idx = 2 * idx + 1 + (~go_left).long()
    vals = leaf[t_ix, idx - ni]
    return torch.tensor(base, dtype=torch.float32) + vals.sum(dim=1)


def _lib() -> ctypes.CDLL:
    lib = _build.load("gbdt")
    fn = lib.gbdt_predict_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_float,
                                               ctypes.c_void_p] + [
            ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        sm = lib.gbdt_smem_bytes
        sm.argtypes, sm.restype = [ctypes.c_int], ctypes.c_size_t
    return lib


@functools.lru_cache(maxsize=None)
def _smem_bytes(t: int) -> int:
    """The kernel's shared memory for a forest of `t` trees (one float a
    tree), asked of the library once per forest size."""
    return _lib().gbdt_smem_bytes(t)


def gbdt_predict(feats, feat, thresh, leaf, base: float,
                 depth: int) -> torch.Tensor:
    """feats [B,F] f32, feat [T,2^D-1] i32, thresh [T,2^D-1] f32,
    leaf [T,2^D] f32 -> [B] f32 ensemble predictions (+ base)."""
    if feats.device.type == "cpu":
        return gbdt_predict_plain(feats, feat, thresh, leaf, base, depth)
    if feats.device.type != "cuda":
        raise ValueError(f"gbdt_predict runs on CUDA or CPU, not {feats.device}")
    b, f = feats.shape
    t, ni = feat.shape
    nl = leaf.shape[1]
    if ni != (1 << depth) - 1 or nl != 1 << depth:
        raise ValueError(f"forest arrays [{t},{ni}]/[{t},{nl}] do not match "
                         f"depth {depth}")
    _build.check_tensors("gbdt_predict", feats.device, (
        (feats, "feats", torch.float32, (b, f)),
        (feat, "feat", torch.int32, (t, ni)),
        (thresh, "thresh", torch.float32, (t, ni)),
        (leaf, "leaf", torch.float32, (t, nl))))
    lib = _lib()
    smem = _smem_bytes(t)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"gbdt_predict needs {smem} B of shared memory for "
                         f"{t} trees; a block has {MAX_SMEM_BYTES}")
    out = torch.empty((b,), dtype=torch.float32, device=feats.device)
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    gbdt_predict.launches += 1
    err = lib.gbdt_predict_f32(feats.data_ptr(), feat.data_ptr(),
                               thresh.data_ptr(), leaf.data_ptr(),
                               float(base), out.data_ptr(), b, f, t, ni, nl,
                               depth, stream)
    _build.check(err, "gbdt")
    return out


gbdt_predict.launches = 0  # kernel launches since the last reset
