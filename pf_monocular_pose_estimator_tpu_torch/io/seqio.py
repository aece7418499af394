"""Recorded-sequence containers, PFSQv1 (port of `io/seqio.py`).

The format is `native/seqio.cpp`'s: a 64-byte header (magic "PFSQv1",
height, width, dtype 0 = uint8, frame count), then per frame a float64
timestamp and the uint8 pixels.  `SequenceWriter` / `SequenceReader` call
the C++ library (built from `native/seqio.cpp` by `utils/native_lib.py`)
or, with `native=False`, a numpy implementation of the same bytes
(`np.memmap` reader).  `native=None` takes the C++ library when a C++
compiler is present; a compiler that fails raises instead of falling back.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Optional, Tuple

import numpy as np

from ..utils import native_lib

_MAGIC = b"PFSQv1\x00\x00"
_HEADER_BYTES = 64


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "sq_create": (_P, [ctypes.c_char_p, _I, _I]),
    "sq_append": (_LL, [_P, _P, ctypes.c_double]),
    "sq_close_writer": (_I, [_P]),
    "sq_open": (_P, [ctypes.c_char_p]),
    "sq_frames": (_LL, [_P]),
    "sq_height": (_I, [_P]),
    "sq_width": (_I, [_P]),
    "sq_frame": (ctypes.POINTER(ctypes.c_ubyte), [_P, _LL, ctypes.POINTER(ctypes.c_double)]),
    "sq_close": (None, [_P]),
}


def _library() -> ctypes.CDLL:
    return native_lib.load("seqio", _SIGNATURES)


def _use_native(native: Optional[bool]) -> bool:
    return native_lib.compiler() is not None if native is None else bool(native)


class SequenceWriter:
    """Streams uint8 frames and their timestamps into a PFSQv1 container."""

    def __init__(self, path: str, height: int, width: int, native: Optional[bool] = None):
        self.height, self.width = int(height), int(width)
        self.n_frames = 0
        self.native = _use_native(native)
        self._h = self._f = None
        if self.native:
            self._lib = _library()
            self._h = self._lib.sq_create(str(path).encode(), self.height, self.width)
            if not self._h:
                raise OSError(f"seqio: cannot create {path}")
        else:
            self._f = open(path, "wb")
            hdr = _MAGIC + struct.pack("<IIIIQ", self.height, self.width, 0, 0, 0)
            self._f.write(hdr + b"\x00" * (_HEADER_BYTES - len(hdr)))

    def append(self, frame: np.ndarray, t: float) -> int:
        """Append one (H, W) uint8 frame; returns the frame count."""
        px = np.ascontiguousarray(frame, dtype=np.uint8)
        if px.shape != (self.height, self.width):
            raise ValueError(f"frame shape {px.shape} != {(self.height, self.width)}")
        if self.native:
            n = self._lib.sq_append(self._h, px.ctypes.data, float(t))
            if n < 0:
                raise OSError("seqio: append failed")
            self.n_frames = int(n)
        else:
            self._f.write(struct.pack("<d", float(t)))
            self._f.write(px.tobytes())
            self.n_frames += 1
        return self.n_frames

    def close(self):
        """Write the frame count into the header and close the file."""
        if self._h:
            if self._lib.sq_close_writer(self._h) != 0:
                raise OSError("seqio: closing the writer failed")
            self._h = None
        elif self._f:
            self._f.seek(24)
            self._f.write(struct.pack("<Q", self.n_frames))
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SequenceReader:
    """PFSQv1 reader whose frames are zero-copy views of the file's mapping
    (native mmap, or `np.memmap`).  A count larger than the file holds is
    clamped to its whole frames."""

    def __init__(self, path: str, native: Optional[bool] = None):
        self.native = _use_native(native)
        self._h = self._mm = None
        if self.native:
            self._lib = _library()
            self._h = self._lib.sq_open(str(path).encode())
            if not self._h:
                raise OSError(f"seqio: cannot open {path}")
            self.n_frames = int(self._lib.sq_frames(self._h))
            self.height = int(self._lib.sq_height(self._h))
            self.width = int(self._lib.sq_width(self._h))
        else:
            with open(path, "rb") as f:
                hdr = f.read(_HEADER_BYTES)
            if hdr[:8] != _MAGIC:
                raise OSError(f"seqio: bad magic in {path}")
            self.height, self.width, dtype, _, n = struct.unpack("<IIIIQ", hdr[8:32])
            if dtype != 0:
                raise OSError("seqio: unsupported dtype")
            self._frame_bytes = 8 + self.height * self.width
            self._mm = np.memmap(path, dtype=np.uint8, mode="r", offset=_HEADER_BYTES)
            self.n_frames = min(n, self._mm.shape[0] // self._frame_bytes)

    def frame(self, i: int) -> Tuple[np.ndarray, float]:
        """(pixels (H, W) uint8, timestamp) of frame i; the pixels are a view."""
        if not 0 <= i < self.n_frames:
            raise IndexError(i)
        if self.native:
            t = ctypes.c_double()
            ptr = self._lib.sq_frame(self._h, i, ctypes.byref(t))
            if not ptr:
                raise IndexError(i)
            return np.ctypeslib.as_array(ptr, shape=(self.height, self.width)), float(t.value)
        off = i * self._frame_bytes
        t = struct.unpack("<d", self._mm[off : off + 8].tobytes())[0]
        px = self._mm[off + 8 : off + self._frame_bytes].reshape(self.height, self.width)
        return px, float(t)

    def arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """The whole sequence copied out: (frames (T, H, W) uint8, times (T,) float64)."""
        frames = np.empty((self.n_frames, self.height, self.width), np.uint8)
        times = np.empty((self.n_frames,), np.float64)
        for i in range(self.n_frames):
            frames[i], times[i] = self.frame(i)
        return frames, times

    def close(self):
        if self._h:
            self._lib.sq_close(self._h)
            self._h = None
        self._mm = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def record_sequence(path: str, frames: np.ndarray, times: np.ndarray,
                    native: Optional[bool] = None) -> int:
    """Write (T, H, W) uint8 frames and their times into a PFSQv1 container;
    returns the frame count."""
    frames = np.asarray(frames)
    with SequenceWriter(path, frames.shape[1], frames.shape[2], native=native) as w:
        for i in range(frames.shape[0]):
            w.append(frames[i], float(times[i]))
    return w.n_frames
