"""Build the hand-written CUDA kernels (`repro_torch/csrc/*.cu`) and load them.

Each source compiles with `nvcc` for Hopper (`sm_90a`) into a shared
library with a plain C interface, loaded with `ctypes` — no PyTorch
headers, so a build takes seconds. The library lands in
`build/repro_torch/` at the repository root, named by a hash of its
source, every shared header (`csrc/*.cuh`) and the flags: the first use
in a process builds it (or finds it built), and an edited source or
header rebuilds.

Every C entry point takes its pointers (K5: an array of them) and the
stream as `void*` and returns `cudaGetLastError()` after its launch;
`check` raises on a non-zero code, and `check_tensors` validates what a
wrapper hands to a kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
SOURCES = ("fused_step", "gbdt", "persistent_step", "quant_rows", "sqdist",
           "topk")
# Dynamic shared memory one H100 thread block can opt into (227 KB); each
# entry point opts its kernel into this much once per device.
MAX_SMEM_BYTES = 232448

_LIBS: dict[str, ctypes.CDLL] = {}  # process-wide cache of loaded libraries


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start nvcc for one source; None when the library is already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all() -> None:
    """Compile every source, one nvcc process each, all started together."""
    jobs = {name: _start_build(name) for name in SOURCES}
    for name, job in jobs.items():
        _finish_build(name, job)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish_build(name, _start_build(name))
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


def check_tensors(kernel: str, device, specs) -> None:
    """Raise ValueError unless every (tensor, name, dtype, shape) of
    `specs` lies contiguous on `device` with that dtype and shape: a
    kernel reads raw pointers and checks nothing itself."""
    for t, name, dtype, shape in specs:
        if (t.device != device or t.dtype != dtype
                or tuple(t.shape) != tuple(shape)):
            raise ValueError(f"{kernel}: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"{dtype} {tuple(shape)} on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def check(err: int, name: str) -> None:
    """Raise when csrc/<name>.cu's entry point reports a CUDA error."""
    if err != 0:
        fn = load(name)[f"{name}_error_string"]
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{name} kernel: CUDA error {err} "
                           f"({fn(err).decode()})")
