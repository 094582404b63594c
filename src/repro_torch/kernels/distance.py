"""Squared L2: the port's one distance expression and kernel K6.

`sqdist_bdrd` is the counterpart of `repro/kernels/distance.py::sqdist_bdrd`.
`sqdist_masked` is K6, the masked batched distance — a wrapper over
`csrc/sqdist.cu` — with its plain version `sqdist_masked_plain`. It
replaces the TPU kernel `repro/kernels/distance.py::_sqdist_kernel`; the
dense backend sends its distances through it under
`SearchConfig(use_pallas=True)`. On the card it computes each (query,
row) pair with K1's code, so its distances equal the fused backend's bit
for bit. Bound on an H100: bytes (each unmasked row is read once); see
the note in `csrc/sqdist.cu`. On CPU tensors the wrapper runs the plain
version; on CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import MAX_SMEM_BYTES

INF = float("inf")


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


def _lib() -> ctypes.CDLL:
    lib = _build.load("sqdist")
    fn = lib.sqdist_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        sm = lib.sqdist_smem_bytes
        sm.argtypes, sm.restype = [ctypes.c_int], ctypes.c_size_t
    return lib


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
    if lib.sqdist_smem_bytes(d) > MAX_SMEM_BYTES:
        raise ValueError(f"sqdist_masked: d={d} needs more than "
                         f"{MAX_SMEM_BYTES} B of shared memory")
    out = torch.empty((b, r), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    sqdist_masked.launches += 1
    err = lib.sqdist_f32(q.data_ptr(), x.data_ptr(), mask.data_ptr(),
                         out.data_ptr(), b, r, d, stream)
    _build.check(err, "sqdist")
    return out


sqdist_masked.launches = 0  # kernel launches since the last reset
