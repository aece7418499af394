"""Peaks of the chip and the least time of kernel B (`pf_step_kernel`).

Frozen copies of `chip_smoke.py::HBM_BYTES_PER_S`, `FP32_OPS_PER_S`,
`bound`, `weight_ops` and `PROPAGATE_OPS`, with B's byte count:
each particle's 16 floats read and written once and its weight written,
N x (64 + 64 + 4) bytes.
"""

from __future__ import annotations

# Peaks of one H100 SXM (NVIDIA's data sheet, at 700 W): HBM bytes per
# second and float32 operations per second outside the tensor cores.  The
# bounds count integer operations at the float32 rate too, so they are
# lower bounds.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# propagation of one particle: two 4x4 composes (224), six threefry draws
# (121 each) with their affine (4 each), six sin/cos, the noise rotation
# (18), the rotated rows (48) and the two lane pins (32)
PROPAGATE_OPS = 224 + 6 * (121 + 4) + 6 + 18 + 48 + 32
PF_STEP_BYTES_PER_PARTICLE = 64 + 64 + 4


def bound(n_bytes: float, n_ops: float):
    """(least time in seconds, what sets it) for moving `n_bytes` once and
    doing `n_ops`."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def weight_ops(m: int, k: int) -> int:
    """Operations the greedy weight of one particle needs with M markers
    and K real detections: 26 M + 9 M K + M (2 M + 12)."""
    return 26 * m + 9 * m * k + m * (2 * m + 12)


def pf_step_bound(n: int, m: int, k: int):
    """Kernel B's least time for N particles, M markers and K real
    detections (every LED seen: K = M on the orbits)."""
    return bound(n * PF_STEP_BYTES_PER_PARTICLE, n * (PROPAGATE_OPS + weight_ops(m, k)))
