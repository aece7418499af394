"""Frame ingestion: a bounded single-producer single-consumer ring of frames
(port of `io/framepipe.py`).

`FramePipe` calls `native/framepipe.cpp` through ctypes (built by
`utils/native_lib.py`): pushes copy a grayscale frame or extract the red
channel of a BGR one in C++, a full ring drops its oldest frame,
`pop_latest` takes the newest and discards the rest, and `start_replay`
pushes a recorded sequence at a given rate from a C++ thread.
`PyFramePipe` does the same in Python, with the same interface and
statistics.  `close()` wakes a waiting consumer and refuses further
pushes; the native pipe is freed (its replay thread joined) when the
object is collected.
"""

from __future__ import annotations

import ctypes
import threading
import time
from collections import deque
from typing import Optional, Tuple

import numpy as np

from ..utils import native_lib

_P, _I, _LL, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
_ULL = ctypes.c_ulonglong
_SIGNATURES = {
    "fp_create": (_P, [_I, _I, _I]),
    "fp_destroy": (None, [_P]),
    "fp_push": (_LL, [_P, _P, _I, _D]),
    "fp_pop": (_LL, [_P, _P, ctypes.POINTER(_D), _I]),
    "fp_pop_latest": (_LL, [_P, _P, ctypes.POINTER(_D), _I, ctypes.POINTER(_I)]),
    "fp_pushed": (_ULL, [_P]),
    "fp_dropped": (_ULL, [_P]),
    "fp_pending": (_I, [_P]),
    "fp_close": (None, [_P]),
    "fp_start_replay": (_I, [_P, _P, _I, _D, _D]),
    "fp_stop_replay": (None, [_P]),
}


class FramePipe:
    """Native SPSC frame ring with red-channel extraction."""

    def __init__(self, width: int, height: int, capacity: int = 8):
        self._lib = native_lib.load("framepipe", _SIGNATURES)
        self._handle = self._lib.fp_create(width, height, capacity)
        if not self._handle:
            raise RuntimeError("fp_create failed")
        self.width = width
        self.height = height
        self._out = np.empty((height, width), np.uint8)
        self._replay_buffer = None  # keeps the replayed frames alive

    def push(self, frame: np.ndarray, timestamp: float) -> int:
        """frame: (H, W) uint8 grayscale or (H, W, 3) uint8 BGR; returns its
        sequence number."""
        frame = np.ascontiguousarray(frame, np.uint8)
        channels = 1 if frame.ndim == 2 else frame.shape[2]
        seq = self._lib.fp_push(self._handle, frame.ctypes.data, channels, timestamp)
        if seq < 0:
            raise RuntimeError("fp_push failed (closed pipe or bad channels)")
        return int(seq)

    def pop(self, timeout_ms: int = 1000) -> Optional[Tuple[np.ndarray, float, int]]:
        """The oldest frame as (frame, timestamp, seq), or None on a timeout or
        a closed, drained pipe."""
        ts = _D()
        seq = self._lib.fp_pop(self._handle, self._out.ctypes.data, ctypes.byref(ts), timeout_ms)
        if seq < 0:
            return None
        return self._out.copy(), ts.value, int(seq)

    def pop_latest(self, timeout_ms: int = 1000):
        """The newest frame, discarding older ones: (frame, timestamp, seq,
        skipped), or None."""
        ts, skipped = _D(), _I()
        seq = self._lib.fp_pop_latest(self._handle, self._out.ctypes.data, ctypes.byref(ts),
                                      timeout_ms, ctypes.byref(skipped))
        if seq < 0:
            return None
        return self._out.copy(), ts.value, int(seq), int(skipped.value)

    def start_replay(self, frames: np.ndarray, fps: float, t0: float = 0.0):
        """Push (T, H, W) uint8 frames from a native thread at `fps`, frame i
        stamped t0 + i / fps."""
        frames = np.ascontiguousarray(frames, np.uint8)
        self._replay_buffer = frames
        rc = self._lib.fp_start_replay(self._handle, frames.ctypes.data, frames.shape[0], fps,
                                       t0)
        if rc != 0:
            raise RuntimeError("fp_start_replay failed")

    def stop_replay(self):
        self._lib.fp_stop_replay(self._handle)

    @property
    def stats(self):
        return {
            "pushed": int(self._lib.fp_pushed(self._handle)),
            "dropped": int(self._lib.fp_dropped(self._handle)),
            "pending": int(self._lib.fp_pending(self._handle)),
        }

    def close(self):
        if self._handle:
            self._lib.fp_close(self._handle)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.fp_destroy(self._handle)
            self._handle = None


class PyFramePipe:
    """The same ring in Python: a bounded deque under a lock."""

    def __init__(self, width: int, height: int, capacity: int = 8):
        self.width = width
        self.height = height
        self._q = deque(maxlen=capacity)
        self._cond = threading.Condition()
        self._pushed = 0
        self._dropped = 0
        self._seq = 0
        self._closed = False
        self._replayer = None
        self._stop = threading.Event()

    def push(self, frame: np.ndarray, timestamp: float) -> int:
        frame = np.asarray(frame, np.uint8)
        if frame.ndim == 3:
            if frame.shape[2] != 3:
                raise RuntimeError("push failed (bad channels)")
            frame = frame[..., 2]  # red of BGR
        with self._cond:
            if self._closed:
                raise RuntimeError("push failed (closed pipe)")
            if len(self._q) == self._q.maxlen:
                self._dropped += 1
            seq = self._seq
            self._q.append((np.array(frame, np.uint8), timestamp, seq))
            self._seq += 1
            self._pushed += 1
            self._cond.notify()
        return seq

    def _wait(self, timeout_ms: int) -> bool:
        """Under the lock: wait for a frame; False on a timeout or a closed,
        drained pipe."""
        return self._cond.wait_for(lambda: self._q or self._closed, timeout_ms / 1000.0) \
            and bool(self._q)

    def pop(self, timeout_ms: int = 1000):
        with self._cond:
            return self._q.popleft() if self._wait(timeout_ms) else None

    def pop_latest(self, timeout_ms: int = 1000):
        with self._cond:
            if not self._wait(timeout_ms):
                return None
            frame, ts, seq = self._q.pop()
            skipped = len(self._q)
            self._q.clear()
            return frame, ts, seq, skipped

    def start_replay(self, frames: np.ndarray, fps: float, t0: float = 0.0):
        if self._replayer is not None or len(frames) == 0 or fps <= 0:
            raise RuntimeError("start_replay failed")
        frames = np.ascontiguousarray(frames, np.uint8)
        self._stop.clear()

        def run():
            start = time.monotonic()
            for i in range(frames.shape[0]):
                if self._stop.wait(max(0.0, start + i / fps - time.monotonic())):
                    return
                try:
                    self.push(frames[i], t0 + i / fps)
                except RuntimeError:  # closed
                    return

        self._replayer = threading.Thread(target=run, daemon=True)
        self._replayer.start()

    def stop_replay(self):
        self._stop.set()
        if self._replayer is not None:
            self._replayer.join()
            self._replayer = None

    @property
    def stats(self):
        with self._cond:
            return {"pushed": self._pushed, "dropped": self._dropped, "pending": len(self._q)}

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()
