"""The port's distributed resampler against the JAX package's, and against
the port's single-device resampler.

The same numpy-seeded weights, bank and key go through the JAX
`make_distributed_resampler` on the virtual CPU devices of
tests/conftest.py and through the port's on a local mesh of as many
shards.  `resampled`, `counts`, `most` and `clipped` must be EQUAL: both
build the CDF with one fixed association, draw from the same threefry
counters, and a gather moves bits.  On the CPU the JAX side takes
`parallel/resample.py:313-320`, the branch without the Pallas layout
pins; the pins are identity copies, so the values are those of the TPU
branch, which kernel H's plain version (`ring_gather_plain`) computes here.

N is a power of two where the JAX side runs: XLA's CPU compiler turns the
division by the constant N inside the jitted shard body into a product
with 1/N, which is the correctly rounded quotient only when 1/N is exact.
The port divides; its equality with its own single-device resampler is
checked at other N as well.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf_monocular_pose_estimator_tpu.parallel.mesh import make_mesh as ref_make_mesh
from pf_monocular_pose_estimator_tpu.parallel.resample import _auto_chunk as ref_auto_chunk
from pf_monocular_pose_estimator_tpu.parallel.resample import _ring_deltas as ref_ring_deltas
from pf_monocular_pose_estimator_tpu.parallel.resample import (
    make_distributed_resampler as ref_make_resampler,
)
from pf_monocular_pose_estimator_tpu_torch.parallel import gather_kernel as hk
from pf_monocular_pose_estimator_tpu_torch.parallel.comm import (
    LocalMesh,
    shard_lanes,
    unshard_lanes,
)
from pf_monocular_pose_estimator_tpu_torch.parallel.resample import (
    auto_chunk,
    make_distributed_resampler,
    ring_deltas,
)
from pf_monocular_pose_estimator_tpu_torch.pf.soa import stratified_resample_soa
from pf_monocular_pose_estimator_tpu_torch.pf.step_kernel import resample_gather_plain

torch.set_num_threads(2)

N = 2048
WIDTHS = (1, 2, 4, 8)


def _bank(rng, n):
    """Random values in the 12 varying rows over the rigid bottom row."""
    b = rng.normal(size=(16, n)).astype(np.float32)
    b[12:15] = 0.0
    b[15] = 1.0
    return b


def _weights(kind, rng, n):
    if kind == "random":
        return rng.uniform(0.1, 2.0, n).astype(np.float32)
    if kind == "zero":
        return np.zeros(n, np.float32)
    if kind == "uniform":
        return np.ones(n, np.float32)
    if kind == "tilted":  # 30% more mass per shard going up: overflows a narrow window
        return (1.0 + 0.3 * (np.arange(n) // (n // 8))).astype(np.float32)
    # tests/test_distributed_resample.py:86-107: all mass on shards 3 and 4 of 8
    s = n // 8
    w = np.full(n, 1e-6, np.float32)
    w[3 * s:5 * s] = 1.0
    return w


def _run_ref(p, key, w, bank, **kw):
    mesh = ref_make_mesh(particle_devices=p, devices=jax.devices()[:p])
    out = jax.jit(ref_make_resampler(mesh, w.shape[0], **kw))(
        jnp.asarray(key, jnp.uint32), jnp.asarray(w), jnp.asarray(bank))
    return (np.asarray(out.resampled), np.asarray(out.counts), int(out.most), int(out.clipped))


def _run_port(p, key, w, bank, **kw):
    mesh = LocalMesh(p)
    resample = make_distributed_resampler(mesh, w.shape[0], **kw)
    out = resample(key, shard_lanes(mesh, torch.from_numpy(w)),
                   shard_lanes(mesh, torch.from_numpy(bank)))
    assert out.resampled.shape == (p, 16, w.shape[0] // p)
    return (unshard_lanes(mesh, out.resampled).numpy(), unshard_lanes(mesh, out.counts).numpy(),
            int(out.most), int(out.clipped))


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2:] == want[2:], f"(most, clipped) {got[2:]} vs {want[2:]}"


# name -> (weights, resampler arguments, widths, whether draws are clipped)
CASES = {
    "auto_window": ("random", dict(), WIDTHS, False),
    "full_blocks": ("random", dict(payload_window=None), WIDTHS, False),
    "zero_weights": ("zero", dict(), WIDTHS, False),
    "uniform_weights": ("uniform", dict(), WIDTHS, False),
    "window_overflow": ("tilted", dict(payload_window=4), (2, 4, 8), True),
    "skew_reach_1": ("skew", dict(reach=1), (8,), True),
    "skew_reach_1_full_blocks": ("skew", dict(reach=1, payload_window=None), (8,), True),
    "skew_reach_7": ("skew", dict(reach=7), (4, 8), False),
}


@pytest.mark.parametrize("case,p", [(case, p) for case in CASES for p in CASES[case][2]])
def test_resampler_equals_jax(case, p):
    kind, kw, _, clips = CASES[case]
    rng = np.random.default_rng(0)
    bank, w = _bank(rng, N), _weights(kind, rng, N)
    key = (0, 7)  # jax.random.PRNGKey(7)
    got, want = _run_port(p, key, w, bank, **kw), _run_ref(p, key, w, bank, **kw)
    _assert_same(got, want)
    assert (got[3] > 0) == clips, f"clipped = {got[3]}"


@pytest.mark.parametrize("n", [2048, 6000, 20_000])
@pytest.mark.parametrize("kind,kw", [("random", dict()), ("random", dict(payload_window=None)),
                                     ("skew", dict(reach=7)), ("zero", dict())])
def test_equals_single_device_and_across_widths(n, kind, kw):
    """Slot for slot the port's sort resampler + gather, at every width
    (tests/test_distributed_resample.py:40, :208, :341 on the JAX side)."""
    rng = np.random.default_rng(1)
    bank, w = _bank(rng, n), _weights(kind, rng, n)
    key = (0, 11)
    anc, counts, most = stratified_resample_soa(key, torch.from_numpy(w))
    want = (resample_gather_plain(torch.from_numpy(bank), anc).numpy(), counts.numpy(), int(most),
            0)
    for p in WIDTHS:
        _assert_same(_run_port(p, key, w, bank, **kw), want)


def test_explicit_chunk_and_odd_shard_size():
    """A shard size the canonical chunk does not divide takes its own chunk;
    widths then agree with each other under one explicit chunk."""
    n = 3000  # default chunk 375; S = 750 at P = 4 (divides), 1000 at P = 3 (does not)
    assert auto_chunk(n, 4) == 375 and auto_chunk(n, 3) == 500
    rng = np.random.default_rng(2)
    bank, w = _bank(rng, n), _weights("random", rng, n)
    runs = [_run_port(p, (0, 3), w, bank, cdf_chunk=250) for p in (1, 2, 3, 4, 6)]
    for other in runs[1:]:
        _assert_same(other, runs[0])


@pytest.mark.parametrize("reach,p", [(1, 1), (1, 2), (1, 8), (2, 4), (7, 8), (3, 5)])
def test_ring_deltas_and_auto_chunk_equal_jax(reach, p):
    assert ring_deltas(reach, p) == ref_ring_deltas(reach, p)
    for n in (2048, 100_000, 1_000_000, 3000):
        if n % p == 0:
            assert auto_chunk(n, p) == ref_auto_chunk(n, p)


def test_resampler_rejects_bad_shapes():
    mesh = LocalMesh(4)
    with pytest.raises(ValueError):
        make_distributed_resampler(mesh, 2050)  # does not divide over 4 shards
    with pytest.raises(ValueError):
        make_distributed_resampler(mesh, 2048, cdf_chunk=7)
    with pytest.raises(ValueError):
        make_distributed_resampler(LocalMesh(1), 1 << 23)
    resample = make_distributed_resampler(mesh, 2048)
    with pytest.raises(ValueError):
        resample((0, 1), torch.ones(2048), torch.ones(16, 2048))  # not in the sharded layout


# ---------------------------------------------------------------- kernel H
def _profile(name, rng):
    if name == "window":  # own block, head window, tail window
        lens = (1000, 250, 250)
    elif name == "full_blocks":  # reach 2: five whole blocks
        lens = (400,) * 5
    else:
        lens = (1000,)
    s = lens[0]
    blocks = [torch.from_numpy(rng.normal(size=(12, n)).astype(np.float32)) for n in lens]
    if name == "identity":
        pos = torch.arange(s, dtype=torch.int32)
    else:
        pos = torch.from_numpy(np.sort(rng.integers(0, sum(lens), s)).astype(np.int32))
        pos[::97] = int(pos[s // 2])  # clamped draws break the order
    return blocks, pos


@pytest.mark.parametrize("name", ["window", "full_blocks", "identity"])
def test_ring_gather_plain_is_the_pinned_gather(name):
    """Kernel H's plain version equals the reference's chain: concatenate,
    `jnp.take` along the lanes, the constant rows (the two pins are
    identity copies); on one block at positions 0..S-1 it returns the
    block over the constant rows."""
    blocks, pos = _profile(name, np.random.default_rng(3))
    got = hk.ring_gather(blocks, pos).numpy()
    cat = jnp.concatenate([jnp.asarray(b.numpy()) for b in blocks], axis=1)
    want = np.concatenate([np.asarray(jnp.take(cat, jnp.asarray(pos.numpy()), axis=1)),
                           np.zeros((3, pos.shape[0]), np.float32),
                           np.ones((1, pos.shape[0]), np.float32)])
    np.testing.assert_array_equal(got, want)
    if name == "identity":
        np.testing.assert_array_equal(got[:12], blocks[0].numpy())


def test_ring_gather_takes_strided_blocks_and_rejects_bad_input():
    rng = np.random.default_rng(4)
    bank = torch.from_numpy(_bank(rng, 64))
    pos = torch.from_numpy(rng.integers(0, 64 + 16, 64).astype(np.int32))
    got = hk.ring_gather([bank[:12], bank[:12, 8:24]], pos)  # views, rows strided
    want = hk.ring_gather_plain([bank[:12].clone(), bank[:12, 8:24].clone()], pos)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        hk.ring_gather([bank], pos)  # 16 rows
    with pytest.raises(ValueError):
        hk.ring_gather([bank[:12]], pos.long())
    with pytest.raises(ValueError):
        hk.ring_gather([bank[:12, ::2]], pos)  # lanes not contiguous
    with pytest.raises(ValueError):
        hk.ring_gather([bank[:12]] * 17, pos)
    with pytest.raises(ValueError):
        hk.ring_gather([], pos)


# ------------------------------------------- kernel H over every local shard
def _ring_shards(profile, shards, s, rng):
    """A sharded bank (L, 16, S) and each shard's ring blocks as the
    resampler builds them on a local mesh: views of the other shards' rows
    (the window profile's tail starts at an unaligned lane), with (L, S)
    positions that land in every block and clamped draws that break their
    order."""
    mesh = LocalMesh(shards)
    bank = torch.from_numpy(rng.normal(size=(shards, 16, s)).astype(np.float32))
    top12 = bank[:, :12]
    if profile == "window":
        w = s // 4
        received = [list(top12), mesh.receive(top12[:, :, :w], -1),
                    mesh.receive(top12[:, :, s - w:], 1)]
    else:  # all reach: whole blocks from up to three shards each way
        received = [mesh.receive(top12, d) for d in ring_deltas(3, shards)]
    blocks = [list(shard) for shard in zip(*received)]
    total = sum(b.shape[1] for b in blocks[0])
    pos = np.sort(rng.integers(0, total, (shards, s)), axis=1).astype(np.int32)
    pos[:, ::97] = pos[:, s // 2:s // 2 + 1]
    pos[:, 0], pos[:, -1] = 0, total - 1
    return bank, blocks, torch.from_numpy(pos)


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
@pytest.mark.parametrize("profile", ["window", "all_reach"])
def test_ring_gather_batched_is_the_pinned_gather(profile, shards):
    """One call over L shards equals, shard by shard, the reference's chain
    (concatenate, `jnp.take`, the constant rows) and the one-shard call."""
    _, blocks, pos = _ring_shards(profile, shards, 1000, np.random.default_rng(5))
    got = hk.ring_gather(blocks, pos)
    assert got.shape == (shards, 16, 1000)
    for i in range(shards):
        cat = jnp.concatenate([jnp.asarray(b.numpy()) for b in blocks[i]], axis=1)
        want = np.concatenate([np.asarray(jnp.take(cat, jnp.asarray(pos[i].numpy()), axis=1)),
                               np.zeros((3, 1000), np.float32), np.ones((1, 1000), np.float32)])
        np.testing.assert_array_equal(got[i].numpy(), want)
        assert torch.equal(hk.ring_gather(blocks[i], pos[i]), got[i])
    assert torch.equal(hk.ring_gather_plain(blocks, pos), got)


@pytest.mark.parametrize("p", range(1, 9))
@pytest.mark.parametrize("reach", [1, 2, 3])
def test_receive_equals_ppermute(reach, p):
    """`LocalMesh.receive` gives, for every delta of the ring, ppermute's
    rows shard by shard, as views of the sent tensor (whole blocks and the
    head and tail windows)."""
    mesh = LocalMesh(p)
    x = torch.arange(p * 3 * 10, dtype=torch.float32).reshape(p, 3, 10)
    for sent in (x, x[:, :, :4], x[:, :, 7:]):
        for d in ring_deltas(reach, p):
            got, want = mesh.receive(sent, d), mesh.ppermute(sent, d)
            assert len(got) == p
            for i in range(p):
                assert torch.equal(got[i], want[i]), f"delta {d}, shard {i}"
                assert got[i].untyped_storage().data_ptr() == x.untyped_storage().data_ptr()


@pytest.mark.parametrize("window", ["auto", None])
def test_local_mesh_gathers_once_from_views(monkeypatch, window):
    """A ring resampling on a local mesh calls kernel H once for all its
    shards, and every bank block it hands over is a view of the bank: no
    copy of the 12 rows is made before the gather."""
    from pf_monocular_pose_estimator_tpu_torch.parallel import resample as resample_mod

    calls = []

    def spy(blocks, take_pos):
        calls.append((blocks, take_pos))
        return hk.ring_gather(blocks, take_pos)

    monkeypatch.setattr(resample_mod, "ring_gather", spy)
    rng = np.random.default_rng(6)
    p, n = 4, 2048
    mesh = LocalMesh(p)
    bank = shard_lanes(mesh, torch.from_numpy(_bank(rng, n)))
    w = shard_lanes(mesh, torch.from_numpy(_weights("random", rng, n)))
    out = make_distributed_resampler(mesh, n, reach=1 if window else 3,
                                     payload_window=window)((0, 7), w, bank)
    assert len(calls) == 1
    blocks, take_pos = calls[0]
    assert len(blocks) == p and take_pos.shape == (p, n // p)
    assert len(blocks[0]) == (3 if window else 4)
    for shard in blocks:
        for b in shard:
            assert b.untyped_storage().data_ptr() == bank.untyped_storage().data_ptr()
    assert out.resampled.shape == (p, 16, n // p) and int(out.clipped) == 0


def test_ring_gather_batched_takes_offset_views():
    """Blocks at arbitrary lane offsets of wider tensors, rows strided."""
    rng = np.random.default_rng(8)
    wide = torch.from_numpy(rng.normal(size=(3, 16, 100)).astype(np.float32))
    blocks = [[wide[i, :12, 3 + i:48 + i], wide[(i + 1) % 3, 1:13, 61:66]] for i in range(3)]
    pos = torch.from_numpy(rng.integers(0, 50, (3, 45)).astype(np.int32))
    want = hk.ring_gather_plain([[b.clone() for b in shard] for shard in blocks], pos)
    assert torch.equal(hk.ring_gather(blocks, pos), want)


def _bad_ring_input(case):
    blk = lambda n=8: torch.zeros(12, n)
    pos = torch.zeros((2, 8), dtype=torch.int32)
    return {
        "pos_int64": ([[blk()], [blk()]], pos.long()),
        "pos_3d": ([[blk()], [blk()]], pos[None]),
        "shards_mismatch": ([[blk()]] * 3, pos),
        "no_blocks": ([[], []], pos),
        "17_blocks": ([[blk()] * 17] * 2, pos),
        "table_over_limit": ([[blk()] * 16] * 17, torch.zeros((17, 8), dtype=torch.int32)),
        "blocks_differ_by_shard": ([[blk(), blk()], [blk()]], pos),
        "lanes_differ_by_shard": ([[blk(8)], [blk(9)]], pos),
        "16_rows": ([[torch.zeros(16, 8)], [torch.zeros(16, 8)]], pos),
        "float64": ([[blk().double()], [blk().double()]], pos),
        "lanes_strided": ([[torch.zeros(12, 16)[:, ::2]], [blk()]], pos),
        "empty_block": ([[blk(0)], [blk(0)]], pos),
    }[case]


@pytest.mark.parametrize("case", ["pos_int64", "pos_3d", "shards_mismatch", "no_blocks",
                                  "17_blocks", "table_over_limit", "blocks_differ_by_shard",
                                  "lanes_differ_by_shard", "16_rows", "float64", "lanes_strided",
                                  "empty_block"])
def test_ring_gather_batched_rejects_bad_input(case):
    blocks, pos = _bad_ring_input(case)
    with pytest.raises(ValueError):
        hk.ring_gather(blocks, pos)


def test_ring_gather_table_limit_is_exact():
    """16 shards of 16 blocks fill the descriptor table and still gather."""
    rng = np.random.default_rng(9)
    blocks = [[torch.from_numpy(rng.normal(size=(12, 4)).astype(np.float32))] * 16] * 16
    pos = torch.from_numpy(rng.integers(0, 64, (16, 8)).astype(np.int32))
    assert len(blocks) * len(blocks[0]) == hk.MAX_ENTRIES
    assert torch.equal(hk.ring_gather(blocks, pos), hk.ring_gather_plain(blocks, pos))
