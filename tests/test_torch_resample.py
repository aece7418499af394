"""Resampling switches against the JAX package: the probe rank, the
windowed decode (kernel F's plain version) with its coverage fallback,
the monotone windowed gather (kernel G's plain version) with its coverage
fallback, the closed-form resampler and the search-based resampler.

Integer outputs (ranks, counts, ancestors) and gathered banks must be
equal: the port repeats the reference's float32 CDF association, its
threefry draws and its seam repairs, and a gather moves bits.  The
Pallas kernels run in interpret mode, with the reference tests' weight
profiles (tests/test_pallas_resample.py, tests/test_pallas_gather.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf_monocular_pose_estimator_tpu.pf.pallas_gather import monotone_gather as ref_monotone_gather
from pf_monocular_pose_estimator_tpu.pf.pallas_resample import probe_rank as ref_probe_rank
from pf_monocular_pose_estimator_tpu.pf.pallas_resample import resample_bank_pallas
from pf_monocular_pose_estimator_tpu.pf.resample import effective_sample_size as ref_ess
from pf_monocular_pose_estimator_tpu.pf.resample import stratified_resample as ref_stratified
from pf_monocular_pose_estimator_tpu.pf.soa import gather_soa as ref_gather
from pf_monocular_pose_estimator_tpu.pf.soa import stratified_resample_closed as ref_closed
from pf_monocular_pose_estimator_tpu_torch.pf import gather_kernel, resample, resample_kernel, soa

torch.set_num_threads(2)

t = lambda a: torch.from_numpy(np.array(a))
key_of = lambda k: tuple(np.asarray(k).tolist())


def _mark_ref(key, weights, bank16):
    return jnp.full_like(bank16, -123.0), jnp.int32(-1)


def _mark(key, weights, bank16):
    return torch.full_like(bank16, -123.0), torch.tensor(-1)


def _profile(kind, n, key):
    """Weight profiles of tests/test_pallas_resample.py: covered
    (softmax(0.8 normal)) and spread (a dead-dense first half), scaled to n."""
    if kind == "covered":
        return jax.nn.softmax(0.8 * jax.random.normal(key, (n,)))
    lane = jnp.arange(n)
    w = jnp.where(lane < n // 2, (lane % 8 == 0).astype(jnp.float32), 1.0)
    return w / jnp.sum(w)


@pytest.mark.parametrize("n,scale", [(4096, 1.5), (10_000, 2.0)])
def test_probe_rank_exact(n, scale):
    """Against the reference run op by op: under `jax.jit` XLA's CPU compiler
    turns the division by the constant N into a product with 1/N, which can
    land an ulp off the correctly rounded quotient (seen at n = 10,000)."""
    key = jax.random.PRNGKey(n)
    w = jax.nn.softmax(scale * jax.random.normal(key, (n,)))
    want = ref_probe_rank(key, w)
    got = resample_kernel.probe_rank(key_of(key), t(w))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[2])


@pytest.mark.parametrize("n,kind", [(2048, "covered"), (4000, "covered"), (4000, "spread"),
                                    (512, "covered")])
def test_resample_bank_matches_pallas(n, kind):
    """Covered profiles take the decode, bit for bit; the spread profile and
    the small-n guard take the fallback on both sides."""
    kw, kb, kr = jax.random.split(jax.random.PRNGKey(7 + n), 3)
    w = _profile(kind, n, kw)
    bank = jax.random.normal(kb, (16, n), jnp.float32)
    want, want_most = resample_bank_pallas(kr, w, bank, _mark_ref, interpret=True)
    got, most, decoded = resample_kernel.resample_bank(key_of(kr), t(w), t(bank), _mark,
                                                       lambda x: x.tolist())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(most) == int(want_most)
    assert decoded == (kind == "covered" and n >= 2048)
    if n >= 2048:
        _, ok = resample_kernel.decode_plain(resample_kernel.probe_rank(key_of(kr), t(w))[0],
                                             t(bank))
        assert bool(ok.all()) == decoded


def test_decoded_bank_is_repeat_of_counts():
    """Where every block is covered the decode equals bank[:, repeat(arange, counts)]."""
    n = 6000
    kw, kb, kr = jax.random.split(jax.random.PRNGKey(3), 3)
    w = t(_profile("covered", n, kw))
    bank = torch.randn(16, n, generator=torch.Generator().manual_seed(0))
    rank, counts, _ = resample_kernel.probe_rank(key_of(kr), w)
    out, ok = resample_kernel.decode_plain(rank, bank)
    assert bool(ok.all())
    anc = torch.repeat_interleave(torch.arange(n), counts.long())
    assert torch.equal(out, bank[:, anc])


def _bank(n, seed):
    b = np.array(jax.random.normal(jax.random.PRNGKey(seed), (16, n)), np.float32)
    b[12:15], b[15] = 0.0, 1.0
    return b


@pytest.mark.parametrize("case", ["uniform", "ragged", "skew", "spread"])
def test_monotone_gather_matches_pallas(case):
    """Kernel G's plain version against `monotone_gather` (interpret): the
    coverage rule picks the same branch, and both branches are exact."""
    n, window = (4608 if case == "ragged" else 4096), 2048
    rng = np.random.default_rng(0)
    if case in ("uniform", "ragged"):
        anc = np.sort(rng.integers(0, n, n))
    elif case == "skew":
        anc = np.sort(np.concatenate([np.full(n // 2, 100), np.full(n // 4, 900),
                                      rng.integers(1000, 2000, n // 8),
                                      rng.integers(2000, 3548, n - n // 2 - n // 4 - n // 8)]))
    else:
        anc = np.sort(np.concatenate([np.zeros(256), np.full(n - 256, n - 1)]))
        window = 1024
    anc = anc.astype(np.int32)
    bank = _bank(n, 5)
    want = ref_monotone_gather(jnp.asarray(bank), jnp.asarray(anc), ref_gather, window=window,
                               interpret=True)
    calls = []

    def fallback(b, a):
        calls.append(1)
        return soa.gather_soa(b, a)

    got = gather_kernel.monotone_gather(t(bank), t(anc).long(), fallback, window=window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _, ok = gather_kernel.monotone_gather_plain(t(bank), t(anc).long(), window=window)
    assert bool(ok.all()) == (case != "spread") == (not calls)


@pytest.mark.parametrize("kind", ["sparse", "peaked", "zeros"])
def test_stratified_resample_closed_exact(kind):
    n = 4096
    rng = np.random.default_rng(len(kind))
    w = np.zeros(n, np.float32)
    if kind == "sparse":
        w = rng.uniform(0, 30, n).astype(np.float32)
        w[rng.random(n) < 0.4] = 0.0
    elif kind == "peaked":
        w[rng.choice(n, 40, replace=False)] = rng.uniform(10, 30, 40).astype(np.float32)
    wn = w / w.sum() if w.sum() > 0 else w
    key = jax.random.PRNGKey(21)
    want = ref_closed(key, jnp.asarray(wn))
    got = soa.stratified_resample_closed(key_of(key), t(wn))
    for g, r in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert int(got[2]) == int(want[2])


@pytest.mark.parametrize("n", [2048, 5000])
def test_stratified_resample_and_ess_exact(n):
    rng = np.random.default_rng(n)
    w = rng.uniform(0, 30, n).astype(np.float32)
    w[rng.random(n) < 0.4] = 0.0
    key = jax.random.PRNGKey(n)
    want = ref_stratified(key, jnp.asarray(w))
    got = resample.stratified_resample(key_of(key), t(w))
    for g, r in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert int(got[2]) == int(want[2])
    assert float(resample.effective_sample_size(t(w))) == pytest.approx(
        float(ref_ess(jnp.asarray(w))), rel=1e-6)
