"""The port's threefry streams against jax.random (jax 0.9, partitionable).

`split`, `PRNGKey` and the [0, 1) uniforms must be bit-identical: the PF
draws of the port are compared with the reference draw for draw.  With
minval/maxval, XLA on the CPU contracts jax's `u * (hi - lo) + lo` into
one FMA while the port (like the Pallas kernel and the CUDA kernel) rounds
the product first; the test pins both sides to those two roundings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf_monocular_pose_estimator_tpu_torch.utils import prng

torch.set_num_threads(2)

SEEDS = (0, 1, 42, 123456789, 2**31 - 1)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_bit_identical(seed):
    key = jax.random.PRNGKey(seed)
    assert tuple(np.asarray(key).tolist()) == prng.prng_key(seed)
    for num in (2, 3, 7):
        want = [tuple(r) for r in np.asarray(jax.random.split(key, num)).tolist()]
        assert prng.split(prng.prng_key(seed), num) == want
    # nested splits, as the tracker chains them
    k1 = jax.random.split(jax.random.split(key)[1], 3)[2]
    p1 = prng.split(prng.split(prng.prng_key(seed))[1], 3)[2]
    assert tuple(np.asarray(k1).tolist()) == p1


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (17,), (3, 1000), (2048,)])
def test_uniform_bit_identical(seed, shape):
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    want = np.asarray(jax.random.uniform(key, shape, jnp.float32))
    got = prng.uniform(tuple(np.asarray(key).tolist()), shape).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_uniform_at_matches_counter_layout():
    key = jax.random.PRNGKey(9)
    full = np.asarray(jax.random.uniform(key, (3, 500)))
    idx = torch.tensor([0, 1, 499, 500, 999, 1000, 1499])
    got = prng.uniform_at(prng.prng_key(9), idx).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(full.reshape(-1)[idx.numpy()]))


def test_uniform_affine_roundings():
    key = jax.random.PRNGKey(5)
    lo = np.float32([-0.1, -0.02, -0.3])[:, None]
    hi = -lo
    want = np.asarray(jax.random.uniform(key, (3, 400), minval=lo, maxval=hi))
    got = prng.uniform(prng.prng_key(5), (3, 400), minval=torch.from_numpy(lo),
                       maxval=torch.from_numpy(hi)).numpy()
    u = prng.uniform(prng.prng_key(5), (3, 400)).numpy()
    fused = np.maximum(lo, (u.astype(np.float64) * (hi - lo) + lo).astype(np.float32))
    rounded = np.maximum(lo, u * (hi - lo) + lo)
    np.testing.assert_array_equal(_bits(want), _bits(fused))  # XLA CPU: one FMA
    np.testing.assert_array_equal(_bits(got), _bits(rounded))  # port: product rounded first
    np.testing.assert_allclose(got, want, rtol=0, atol=6e-8)  # <= 2 ulp at |x| <= 0.3
