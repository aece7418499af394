"""Build and load the port's CUDA kernels (csrc/*.cu) as one shared library.

The library is compiled by `nvcc` at first use into `build/torch_kernels/`
at the repository root, named after a hash of the sources, headers and
flags, so an edited source rebuilds and an unchanged one loads in
milliseconds.  Each source compiles in its own `nvcc` process, all started
together, and one more `nvcc` links the objects.  Each C entry point
takes the CUDA stream, allocates nothing and returns `cudaGetLastError()`;
`check()` raises on a non-zero code.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("detect.cu", "pf_step.cu", "pf_weight.cu", "resample_gather.cu", "resample_decode.cu",
           "monotone_gather.cu", "ring_gather.cu", "gn_refine.cu")
HEADERS = ("pf_common.cuh",)
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_SIGNATURES = {
    "pfmpe_threshold_blur": (_P, _P, _I, _I, _I, _I, _P, _P),
    "pfmpe_detect_stats": (_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P),
    "pfmpe_detect_stats_scratch": (_I, _I, _I, _I),
    "pfmpe_detect_epilogue": (_P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _F, _F, _F, _P, _P, _P, _P,
                              _P, _P, _P, _P),
    "pfmpe_pf_step": (_P, _P, _I, _I, _I, _U, _U, _U, _U, _I, _I, _P, _P, _P, _P, _P),
    "pfmpe_pf_weight": (_P, _P, _I, _I, _I, _P, _P, _P, _P),
    "pfmpe_resample_gather": (_P, _P, _I, _P, _P),
    "pfmpe_resample_decode": (_P, _P, _I, _I, _I, _P, _P, _P, _P),
    "pfmpe_monotone_gather": (_P, _P, _I, _I, _I, _P, _P, _P),
    "pfmpe_ring_gather": (_P, _P, _P, _I, _I, _P, _I, _P, _P),
    "pfmpe_gn_refine": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P, _P, _P, _P),
    "pfmpe_refine_frame": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F,
                           _I, _P, _P, _P, _P),
    "pfmpe_refine_pose": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P, _P),
}

_lib = None
build_seconds = None


def build_dir() -> Path:
    return _CSRC.parent.parent / "build" / "torch_kernels"


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def digest(flags, files) -> str:
    """A hash of the flags and of each file's name and bytes."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in files:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def cached_build(stem: str, flags, files, build, directory=None) -> Path:
    """`directory/lib{stem}_{digest}.so` (`build_dir()` unless given), made
    first if absent: `build(tmp, out)` writes it to `out` in the temporary
    directory `tmp`, and it is moved into place whole, so a build that fails
    or runs beside another leaves no partial library behind."""
    out_dir = build_dir() if directory is None else Path(directory)
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"lib{stem}_{digest(flags, files)}.so"
    if not so.exists():
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            out = os.path.join(tmp, so.name)
            build(tmp, out)
            os.replace(out, so)
    return so


def _build(tmp: str, out: str) -> None:
    """One nvcc per source, all running at once, then one link into `out`."""
    nvcc = _nvcc()
    objs = [os.path.join(tmp, name + ".o") for name in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(_CSRC / name)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, obj in zip(SOURCES, objs)]
    errors = []
    for name, proc in zip(SOURCES, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name} ({proc.returncode}):\n{err}")
    if errors:
        raise RuntimeError("nvcc failed: " + "\n".join(errors))
    proc = subprocess.run([nvcc, *ARCH, "-shared", "-o", out, *objs], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")


def library(directory=None) -> ctypes.CDLL:
    """The loaded kernel library, compiled first if its sources changed.

    With `directory`, the library is built there (in a fresh directory, a
    cold build) and loaded in place of any loaded before, so every kernel
    launched after the call comes from it."""
    global _lib, build_seconds
    if _lib is not None and directory is None:
        return _lib
    t0 = time.perf_counter()
    so = cached_build("pfmpe_kernels", NVCC_FLAGS, [_CSRC / n for n in SOURCES + HEADERS], _build,
                      directory)
    lib = ctypes.CDLL(str(so))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    _lib = lib
    build_seconds = time.perf_counter() - t0
    return lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
