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

from pf_monocular_pose_estimator_tpu.pf import pallas_resample
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


def hand_rank(case, n):
    """Hand-made ranks for the decode, each with rank[n - 1] = n as a probe
    rank has: 'one_chunk' sends every slot to one ancestor; 'coarse_past_window'
    spreads a block's ancestors over more chunks than its window holds;
    'step_down' lowers one chunk-last rank below a block start that the
    chunks before it exceed, so a count and a search of the chunk-last
    ranks disagree (the count is the reference's window start)."""
    j = np.arange(n)
    if case == "one_chunk":
        rank = np.where(j < 3000, 0, n)
    elif case == "coarse_past_window":
        rank = j // 16
        rank[-1] = n
    else:
        rank = j + 1
        rank[20 * 128 + 127] = 2000
    return rank.astype(np.int32)


def count_and_search_differ(rank, block=resample_kernel.BLOCK):
    """Whether some block's window start, #{chunk-last ranks <= its first
    slot}, differs from a binary search of the chunk-last ranks."""
    n = rank.shape[0]
    padded = np.full(-(-n // 128) * 128, resample_kernel.BIG_RANK, np.int64)
    padded[:n] = rank
    last = padded.reshape(-1, 128)[:, -1]
    t0 = np.arange(-(-n // block)) * block
    count = (last[None, :] <= t0[:, None]).sum(1)
    return bool((count != np.searchsorted(last, t0, side="right")).any())


@pytest.mark.parametrize("case,n", [("covered", 1536), ("covered", 6001), ("spread", 4097),
                                    ("one_chunk", 6001), ("coarse_past_window", 6001),
                                    ("step_down", 6001)])
def test_decode_plain_matches_pallas_every_block(case, n, monkeypatch):
    """Kernel F's plain version against `_decode_pallas` (interpret) on every
    block, covered or not, as `resample_bank_pallas` calls it (its window
    starts and boundary ranks): N equal to the window, N not a multiple of
    128 or of 4, a last block of one slot, and the hand-made ranks."""
    seen = {}
    decode_ref = pallas_resample._decode_pallas

    def recorded(rank_pad_f32, *args, **kwargs):
        seen["rank"] = np.asarray(rank_pad_f32)[:n].astype(np.int32)
        seen["out"], seen["ok"] = decode_ref(rank_pad_f32, *args, **kwargs)
        return seen["out"], seen["ok"]

    monkeypatch.setattr(pallas_resample, "_decode_pallas", recorded)
    if case not in ("covered", "spread"):
        rank = jnp.asarray(hand_rank(case, n))
        monkeypatch.setattr(pallas_resample, "probe_rank",
                            lambda key, w: (rank, jnp.diff(rank, prepend=0), jnp.int32(0)))
    kw, kb, kr = jax.random.split(jax.random.PRNGKey(n), 3)
    w = _profile(case if case == "spread" else "covered", n, kw)
    bank = jax.random.normal(kb, (16, n), jnp.float32)
    resample_bank_pallas(kr, w, bank, _mark_ref, interpret=True)
    out, ok = resample_kernel.decode_plain(t(seen["rank"]), t(bank))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(seen["ok"]).reshape(-1))
    np.testing.assert_array_equal(out.numpy(), np.asarray(seen["out"]))
    if case == "step_down":
        assert count_and_search_differ(seen["rank"])
    if case in ("spread", "coarse_past_window"):
        assert not bool(ok.all())


@pytest.mark.parametrize("n,block,window,kind", [(2048, 512, 2048, "uniform"),
                                                 (6001, 512, 2048, "uniform"),
                                                 (4097, 512, 2048, "skew"),
                                                 (6001, 128, 2048, "uniform"),
                                                 (6001, 1024, 2048, "skew"),
                                                 (6001, 512, 1024, "uniform")])
def test_monotone_gather_matches_pallas_edge_cases(n, block, window, kind):
    """Kernel G's plain version against `monotone_gather` (interpret) with a
    fallback on each side that marks its output, so equal outputs mean the
    same branch: N equal to the window, N not a multiple of 128 or of 4, a
    last block of one slot, other blocks and a narrower window."""
    rng = np.random.default_rng(n + block + window)
    anc = np.sort(rng.integers(0, n, n))
    if kind == "skew":  # the middle third crowds onto a few ancestors
        anc[n // 3: 2 * n // 3] = np.sort(rng.integers(0, 4, 2 * n // 3 - n // 3)) * (n // 4)
        anc = np.sort(anc)
    bank = _bank(n, 6)
    want = ref_monotone_gather(jnp.asarray(bank), jnp.asarray(anc.astype(np.int32)),
                               lambda b, a: jnp.full_like(b, -123.0), block=block, window=window,
                               interpret=True)
    got = gather_kernel.monotone_gather(t(bank), t(anc), lambda b, a: torch.full_like(b, -123.0),
                                        block=block, window=window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    out, ok = gather_kernel.monotone_gather_plain(t(bank), t(anc), block, window)
    # the reference's rule never covers the last N mod 128 lanes
    assert bool(ok.all()) == (kind == "uniform" and n % 128 == 0)
    assert torch.equal(out[:, ok.repeat_interleave(block)[:n] == 1],
                       t(bank)[:, t(anc)][:, ok.repeat_interleave(block)[:n] == 1])


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
