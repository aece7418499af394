"""Build and load the repo's host C++ libraries (`native/*.cpp`).

`io/seqio.py` and `io/framepipe.py` call into `native/seqio.cpp` and
`native/framepipe.cpp` through ctypes.  Each source is compiled with the
host C++ compiler and `native/Makefile`'s flags into `build/torch_kernels/`,
named after a hash of the source and flags (`cuda_lib.cached_build`), and
never into `native/`.  A compiler that fails raises with its stderr.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

from .cuda_lib import cached_build

NATIVE = Path(__file__).resolve().parents[2] / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_loaded: dict = {}


def compiler() -> str | None:
    """The host C++ compiler (`$CXX`, else `c++`, else `g++`), or None."""
    for cand in (os.environ.get("CXX", ""), "c++", "g++"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    return None


def build(source: Path) -> Path:
    """Compile `source` into a shared library (once for each source and flags)."""
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler found: set CXX or put c++ on PATH")

    def run(tmp: str, out: str) -> None:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", out, str(source)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {source} ({proc.returncode}):\n{proc.stderr}")

    return cached_build(Path(source).stem, CXX_FLAGS, [Path(source)], run)


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """`native/{name}.cpp` built if needed and loaded, once a process, with
    `signatures` ({function: (restype, argtypes)}) set on its functions."""
    if name not in _loaded:
        lib = ctypes.CDLL(str(build(NATIVE / f"{name}.cpp")))
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _loaded[name] = lib
    return _loaded[name]
