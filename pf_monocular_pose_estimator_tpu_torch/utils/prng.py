"""Threefry-2x32 counter streams, bit-identical to `jax.random` (jax 0.9,
`jax_threefry_partitionable=True`).

A key is two 32-bit words `(k0, k1)`, carried as Python ints on the host
(the tracker state holds them as a (2,) int64 CPU tensor).  Splitting a
key hashes tiny counters, so it stays on the host; bank-sized uniforms are
hashed on the tensor's device.

torch has no uint32 add or shift on the CPU, so tensors are int64 holding
values in [0, 2**32) and every add is masked back to 32 bits.  The same
code runs on Python ints.

Layout of the partitionable stream (reference: `pf/soa.py::_uniform_at`,
`pf/pallas_step.py::_threefry2x32` and its in-kernel draw):
  * element `i` of a flat array of `n < 2**32` elements hashes the
    counter words `(hi, lo) = (0, i)`; its 32 random bits are `o1 ^ o2`;
  * `split(key, num)[i] = (o1, o2)` of the same hash at counter `i`;
  * a float32 uniform is `bitcast((bits >> 9) | 0x3F800000) - 1`;
  * `fold_in(key, d)` hashes the counter words `(0, d)`, so it equals
    `split(key, d + 1)[d]`.

`bernoulli`, `rademacher` and `randint` draw a handful of values for the
fault injector: they hash on the host and put the values on `device`.
"""

from __future__ import annotations

import math

import torch

from .sync import upload

MASK = 0xFFFFFFFF
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)


def _rotl(v, d):
    return ((v << d) | (v >> (32 - d))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """The threefry-2x32 block function (20 rounds) on ints or int64 tensors."""
    ks = (k0, k1, (k0 ^ k1 ^ 0x1BD11BDA) & MASK)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT_A if i % 2 == 0 else _ROT_B:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """`jax.random.PRNGKey(seed)` for a 32-bit seed."""
    return ((seed >> 32) & MASK, seed & MASK)


def split(key, num: int = 2) -> list[tuple[int, int]]:
    """`jax.random.split(key, num)` as a list of (k0, k1) host words."""
    k0, k1 = int(key[0]), int(key[1])
    return [threefry2x32(k0, k1, 0, i) for i in range(num)]


def fold_in(key, data: int) -> tuple[int, int]:
    """`jax.random.fold_in(key, data)` for a 32-bit `data`."""
    return threefry2x32(int(key[0]), int(key[1]), 0, int(data) & MASK)


def random_bits(key, counters: torch.Tensor) -> torch.Tensor:
    """32 random bits (int64 in [0, 2**32)) at the given flat counters."""
    k0, k1 = int(key[0]), int(key[1])
    c = counters.to(torch.int64)
    o1, o2 = threefry2x32(k0, k1, torch.zeros_like(c), c)
    return o1 ^ o2


def bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """Map 32 random bits to a float32 in [0, 1) exactly as jax does."""
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def uniform_at(key, counters: torch.Tensor) -> torch.Tensor:
    """`jax.random.uniform(key, (n,), float32)[counters]` without the array."""
    return bits_to_unit_float(random_bits(key, counters))


def uniform(key, shape, device="cpu", minval=0.0, maxval=1.0) -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`.

    minval/maxval may be floats or float32 tensors broadcastable to `shape`;
    jax's affine is `max(minval, u * (maxval - minval) + minval)`."""
    u = uniform_at(key, torch.arange(math.prod(shape), device=device)).reshape(shape)
    if isinstance(minval, float) and isinstance(maxval, float) and (minval, maxval) == (0.0, 1.0):
        return u
    lo = upload(minval, device)
    hi = upload(maxval, device)
    return torch.maximum(lo, u * (hi - lo) + lo)


def bernoulli(key, p: float, shape, device="cpu") -> torch.Tensor:
    """`jax.random.bernoulli(key, p, shape)` for a float32 `p`: `uniform < p`."""
    return upload(uniform(key, shape) < p, device, torch.bool)


def rademacher(key, shape, device="cpu") -> torch.Tensor:
    """`jax.random.rademacher(key, shape)`: int32 values of -1 or 1."""
    return 2 * bernoulli(key, 0.5, shape, device).to(torch.int32) - 1


def randint(key, shape, minval, maxval, device="cpu") -> torch.Tensor:
    """`jax.random.randint(key, shape, minval, maxval)` with int32 values.

    The bounds are ints, or int tensors on `device`, in int32's range that
    broadcast to `shape`.  As jax does, two 32-bit draws under `split(key)`
    are reduced modulo the span in uint32 arithmetic, products and sums
    wrapping at 2**32, and a span of `maxval <= minval` is 1."""
    for v in (minval, maxval):
        if not isinstance(v, torch.Tensor) and not -2**31 <= int(v) < 2**31:
            raise ValueError(f"randint bounds must lie in int32's range, got {v}")
    k1, k2 = split(key)
    counters = torch.arange(math.prod(shape))
    upper = upload(random_bits(k1, counters).reshape(shape), device, torch.int64)
    lower = upload(random_bits(k2, counters).reshape(shape), device, torch.int64)
    lo_v = upload(minval, device, torch.int64)
    hi_v = upload(maxval, device, torch.int64)
    span = torch.where(hi_v <= lo_v, torch.ones_like(hi_v), (hi_v - lo_v) & MASK)
    # 2**32 % span as uint32 computes it: 0 for a span above 2**16, so no
    # product below exceeds 2**32
    mult = ((65536 % span) ** 2 & MASK) % span
    offset = ((((upper % span) * mult) & MASK) + lower % span) & MASK
    out = lo_v + offset % span
    return (((out + 2**31) & MASK) - 2**31).to(torch.int32)
