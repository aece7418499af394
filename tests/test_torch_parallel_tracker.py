"""The sharded slice end to end on the CPU: kernel B's plain version per
shard, the sharded tracker on a local mesh against the port's unsharded
tracker and against the JAX sharded tracker, and two `gloo` ranks against
the local mesh.

The port's sharded tracker sums the weights per shard and then over shards,
which rounds differently from the unsharded `torch.sum`; the JAX test of
the same property (tests/test_sharded_pallas.py:127-136) allows
atol = 1e-4 on pose and bank and demands equal fail flags, and so does
this file.  Two ranks against a local mesh of two shards must be EQUAL:
every collective returns the same values on both meshes.

Run as a script this file is one rank of the two-rank test:
    python tests/test_torch_parallel_tracker.py RANK WORLD RENDEZVOUS_FILE OUT.npz
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf_monocular_pose_estimator_tpu.geometry.camera import Camera as RefCamera
from pf_monocular_pose_estimator_tpu.parallel.mesh import make_mesh as ref_make_mesh
from pf_monocular_pose_estimator_tpu.parallel.mesh import make_sharded_tracker as ref_sharded
from pf_monocular_pose_estimator_tpu.parallel.mesh import shard_target_state as ref_shard_state
from pf_monocular_pose_estimator_tpu.tracker import TargetState as RefState
from pf_monocular_pose_estimator_tpu.utils import TrackerConfig as RefConfig
from pf_monocular_pose_estimator_tpu_torch.geometry import Camera, exp_se3, project
from pf_monocular_pose_estimator_tpu_torch.parallel import (
    LocalMesh,
    make_distributed_resampler,
    make_mesh,
    make_sharded_tracker,
    shard_lanes,
    shard_target_state,
    unshard_lanes,
    unshard_target_state,
)
from pf_monocular_pose_estimator_tpu_torch.parallel import distributed
from pf_monocular_pose_estimator_tpu_torch.parallel.bank import ShardedBank
from pf_monocular_pose_estimator_tpu_torch.parallel.pf_kernels import make_sharded_pf_fn
from pf_monocular_pose_estimator_tpu_torch.pf import step_kernel as sk
from pf_monocular_pose_estimator_tpu_torch.pf.propagate import NoiseBounds
from pf_monocular_pose_estimator_tpu_torch.pf.soa import propagate_soa
from pf_monocular_pose_estimator_tpu_torch.pf.weight_kernel import weight_particles_bank
from pf_monocular_pose_estimator_tpu_torch.tracker import TargetState, make_tracker
from pf_monocular_pose_estimator_tpu_torch.tracker.bank import WholeBank
from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig
from pf_monocular_pose_estimator_tpu_torch.utils.prng import prng_key

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
N = 4096  # a power of two: the jitted JAX step then divides by N exactly (ROADMAP fault 3f)
CONFIG = dict(n_particles=N, min_blob_area=8.0, pf_max_retries=8)
N_RANKS = 2  # of the gloo test
N_GLOO = 2048
GLOO_FRAMES = 4
ONES5 = torch.ones(5, dtype=torch.bool)


def _golden():
    d = dict(np.load(os.path.join(HERE, "golden", "golden_sequence.npz")))
    args = (float(d["fx"]), float(d["fy"]), float(d["cx"]), float(d["cy"]),
            np.asarray(d["dist"], np.float32), int(d["width"]), int(d["height"]))
    markers = np.concatenate([d["markers"], np.ones((5, 1), np.float32)], 1)
    return d, args, markers


@pytest.fixture(scope="module")
def golden():
    d, args, markers = _golden()
    return dict(d=d, args=args, cam=Camera.create(*args), markers=torch.from_numpy(markers))


def _replay(step, state, d, n_frames, mesh=None):
    """Step the first frames -> per frame (flag, pose, whole bank, clipped)."""
    rows = []
    for i in range(n_frames):
        state, res = step(state, torch.from_numpy(d["frames"][i]), float(d["times"][i]))
        whole = state if mesh is None else unshard_target_state(state, mesh)
        rows.append((int(res.fail_flag), res.pose.numpy(), whole.bank.numpy(),
                     int(res.resample_clipped)))
    return rows, state


# --------------------------------------------------- kernel B on a shard
def _pf_inputs(n, cam):
    rng = np.random.default_rng(0)
    gt = exp_se3(torch.tensor([0.02, -0.01, 0.0, 0.1, -0.2, 0.3]))
    gt[2, 3] += 1.3
    tw = torch.from_numpy(rng.normal(0, 0.02, (n, 6)).astype(np.float32))
    bank = (exp_se3(tw) @ gt).reshape(n, 16).T.contiguous()
    markers = torch.cat([torch.from_numpy(rng.normal(0, 0.08, (5, 3)).astype(np.float32)),
                         torch.ones(5, 1)], 1)
    det_xy = torch.zeros(16, 2)
    det_xy[:5] = project(cam, gt, markers)
    det_mask = torch.arange(16) < 5
    return gt, bank, markers, det_xy, det_mask


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_lane_offset_shards_bit_identical(golden, shards):
    """Per-shard passes with lane_offset / n_total concatenate to exactly
    the whole-bank pass, lanes 0 / 1 pinned on the first shard only (the
    port's twin of tests/test_sharded_pallas.py:50), for kernel B's plain
    version, for the hook `make_sharded_pf_fn` builds, and for the torch-op
    propagation."""
    n = 2048
    cam = golden["cam"]
    gt, bank, markers, det_xy, det_mask = _pf_inputs(n, cam)
    step = exp_se3(torch.tensor([0.002, -0.001, 0.003, 0.01, 0.0, -0.01]))
    noise = NoiseBounds(-0.01, 0.01, -0.02, 0.02)
    args = (prng_key(5), gt, gt @ step, step, torch.eye(4), noise, 1.0, 1.0, True, True, 1.0)
    weigh = (markers, ONES5, det_xy, det_mask, 10.0, 5.0, torch.zeros(5, dtype=torch.bool), 5.0)
    b_full, w_full = sk.fused_propagate_weight(args[0], bank, *args[1:], cam, *weigh,
                                               want_pairs=False)
    assert float(w_full.max()) > 20.0, "no particle matched the detections"
    s = n // shards
    parts = [sk.fused_propagate_weight(args[0], bank[:, i * s:(i + 1) * s], *args[1:], cam,
                                       *weigh, want_pairs=False, lane_offset=i * s, n_total=n)
             for i in range(shards)]
    assert torch.equal(torch.cat([b for b, _ in parts], 1), b_full)
    assert torch.equal(torch.cat([w for _, w in parts]), w_full)
    assert torch.equal(b_full[:, 0], gt.reshape(16)) and torch.equal(b_full[:, 1],
                                                                     (gt @ step).reshape(16))
    assert not torch.equal(parts[1][0][:, 0], gt.reshape(16)), "a later shard pinned its lane 0"

    mesh = LocalMesh(shards)
    for fused in (True, False):
        config = TrackerConfig(n_particles=n, use_fused_pf_kernel=fused)
        pf_fn = make_sharded_pf_fn(mesh, cam, config)
        b_sh, w_sh = pf_fn(args[0], shard_lanes(mesh, bank), *args[1:], *weigh)
        assert b_sh.shape == (shards, 16, s) and w_sh.shape == (shards, s)
        if fused:
            want_b, want_w = b_full, w_full
        else:
            want_b = propagate_soa(args[0], bank, *args[1:])
            want_w = weight_particles_bank(cam, want_b, *weigh)[0]
        assert torch.equal(unshard_lanes(mesh, b_sh), want_b)
        assert torch.equal(unshard_lanes(mesh, w_sh), want_w)


def test_sharded_bank_reductions_equal_whole_bank():
    """Max, argmax and lane reads are exact; the moments differ from
    `torch.sum` of the whole by rounding only; seeds land by global lane."""
    rng = np.random.default_rng(1)
    n = 4096
    w = torch.from_numpy(rng.uniform(0, 30, n).astype(np.float32))
    w[[700, 3100]] = 40.0  # a tie: the first lane wins
    bank = torch.from_numpy(rng.normal(size=(16, n)).astype(np.float32))
    seeds = torch.from_numpy(rng.normal(size=(6, 4, 4)).astype(np.float32))
    seed_mask = torch.tensor([True, False, True, True, False, True])
    whole = WholeBank()
    for p in (1, 2, 4, 8):
        mesh = LocalMesh(p)
        ops, ws, bs = ShardedBank(mesh), shard_lanes(mesh, w), shard_lanes(mesh, bank)
        assert ops.n_lanes(ws) == whole.n_lanes(w) == n
        assert torch.equal(ops.max(ws), whole.max(w))
        assert int(ops.argmax(ws)) == int(whole.argmax(w)) == 700
        for got, want in zip(ops.moments(ws), whole.moments(w)):
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        for lane in (0, 1, n // p - 1, n // p % n, 2500, n - 1):
            idx = torch.tensor(lane)
            assert torch.equal(ops.pick_lane(bs, idx), whole.pick_lane(bank, idx))
        for k in (1, 128, n // p, min(n, n // p + 5)):
            assert torch.equal(ops.head(bs, k), whole.head(bank, k))
        assert torch.equal(unshard_lanes(mesh, ops.fill_seeds(bs, seeds, seed_mask)),
                           whole.fill_seeds(bank, seeds, seed_mask))


# ------------------------------------------------ sharded tracker, local
# name -> (config overrides, ring arguments, frames).  With the default ring
# (reach 1, a window of S / 4) the ESS gate first fires on frame 12 and the
# weight skew first overflows the window on frame 16, so those cases stop
# before it; whole blocks from every shard cannot clip.
SHARDED_CASES = {
    "main": (dict(), dict(), 16),
    "resample_every_frame": (dict(resample_min_ess=0.0), dict(), 8),
    "unfused": (dict(use_fused_pf_kernel=False, resample_min_ess=0.0), dict(), 8),
    "every_block_reaches": (dict(), dict(resample_reach=3, payload_window=None), 30),
}


@pytest.mark.parametrize("case", list(SHARDED_CASES))
def test_sharded_tracker_matches_unsharded(golden, case):
    """P = 4 on a local mesh against the unsharded tracker over the first
    golden frames (init, PF, resampling): equal fail flags, pose and bank
    within atol = 1e-4, nothing clipped."""
    d = golden["d"]
    overrides, ring, n_frames = SHARDED_CASES[case]
    config = TrackerConfig(**CONFIG, **overrides)
    mesh = make_mesh(4)
    plain = make_tracker(golden["cam"], golden["markers"], ONES5, config, device="cpu")
    sharded = make_sharded_tracker(golden["cam"], golden["markers"], ONES5, config, mesh,
                                   device="cpu", **ring)
    state = TargetState.create(N, prng_key(0), device="cpu")
    want, _ = _replay(plain, state, d, n_frames)
    got, last = _replay(sharded, shard_target_state(state, mesh), d, n_frames, mesh)
    assert last.bank.shape == (4, 16, N // 4) and last.weights.shape == (4, N // 4)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[0] == w[0], f"frame {i}: flag {g[0]} vs {w[0]}"
        np.testing.assert_allclose(g[1], w[1], atol=1e-4, err_msg=f"frame {i} pose")
        np.testing.assert_allclose(g[2], w[2], atol=1e-4, err_msg=f"frame {i} bank")
        assert g[3] == 0, f"frame {i}: {g[3]} draws clipped"
    assert sum(g[0] == 10 for g in got) >= n_frames - 1, "the PF branch should track"
    assert sharded.host.count == plain.host.count, "sharding must add no device->host sync"


def test_sharded_tracker_against_jax_sharded(golden):
    """The port's sharded tracker (P = 4, local mesh) against the JAX
    `make_sharded_tracker` on 4 virtual CPU devices over the first golden
    frames.  The JAX side runs `pf_pallas="interpret"`: kernel #3 per shard
    in interpret mode, which is what the port's kernel B computes; its
    detection and weight of single poses still take the CPU's XLA paths
    (ROADMAP fault 3a), so the tolerances are those of
    tests/test_torch_tracker.py: 0.1 mm on frame 0, 0.05 mm and 0.1 deg
    later, equal fail flags.

    Both run the default ring (reach 1, a window of S / 4).  On this
    sequence the weight skew between shards overflows that window from frame
    16 on, in the reference as in the port: nothing is clipped before it, and
    from there both count the same clipped draws (to 2%: the two sides'
    weights differ by rounding)."""
    d = golden["d"]
    n_frames = 20
    mesh = make_mesh(4)
    step = make_sharded_tracker(golden["cam"], golden["markers"], ONES5, TrackerConfig(**CONFIG),
                                mesh, device="cpu")
    state = shard_target_state(TargetState.create(N, prng_key(0), device="cpu"), mesh)
    got, _ = _replay(step, state, d, n_frames, mesh)

    ref_mesh = ref_make_mesh(particle_devices=4, devices=jax.devices()[:4])
    ref_step = ref_sharded(RefCamera.create(*golden["args"]),
                           jnp.asarray(golden["markers"].numpy()), jnp.ones(5, bool),
                           RefConfig(**CONFIG), ref_mesh, pf_pallas="interpret")
    ref_state = ref_shard_state(RefState.create(N, jax.random.PRNGKey(0)), ref_mesh)
    for i in range(n_frames):
        ref_state, res = ref_step(ref_state, jnp.asarray(d["frames"][i], jnp.float32),
                                  jnp.asarray(d["times"][i]))
        flag, pose, _, clipped = got[i]
        ref_pose, ref_clipped = np.asarray(res.pose), int(res.resample_clipped)
        assert flag == int(res.fail_flag), f"frame {i}: flag {flag} vs {int(res.fail_flag)}"
        d_t = float(np.linalg.norm(pose[:3, 3] - ref_pose[:3, 3]))
        cos = (np.trace(pose[:3, :3] @ ref_pose[:3, :3].T) - 1.0) / 2.0
        ang = float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))
        assert d_t < (1e-4 if i == 0 else 5e-5), f"frame {i}: {d_t * 1e3:.4f} mm"
        assert ang < 0.1, f"frame {i}: {ang:.3f} deg"
        if i < 16:
            assert clipped == 0 and ref_clipped == 0, f"frame {i}: {clipped}, {ref_clipped}"
        else:
            assert ref_clipped > 0, f"frame {i}: the reference clipped nothing"
            assert abs(clipped - ref_clipped) <= 0.02 * ref_clipped, \
                f"frame {i}: clipped {clipped} vs {ref_clipped}"


def test_distributed_entry_single_process():
    """One process: initialisation is a no-op, the pod mesh one local
    shard, and `run_multihost` takes the reference's arguments (it runs in
    tests/test_torch_parallel_multi.py)."""
    assert distributed.initialize_distributed() == 0
    assert distributed.initialize_distributed("file:///nowhere", 1, 0) == 0
    mesh = distributed.make_pod_mesh()
    assert isinstance(mesh, LocalMesh) and mesh.size == 1
    frame = distributed.broadcast_frame(np.arange(6, dtype=np.uint8).reshape(2, 3), "cpu")
    assert frame.dtype == torch.float32 and frame.tolist() == [[0, 1, 2], [3, 4, 5]]
    with pytest.raises(SystemExit) as done:
        distributed.run_multihost(["--help"])
    assert done.value.code == 0


# ------------------------------------------------------ two gloo ranks
def _gloo_inputs():
    rng = np.random.default_rng(7)
    bank = rng.normal(size=(16, N_GLOO)).astype(np.float32)
    bank[12:15] = 0.0
    bank[15] = 1.0
    w = rng.uniform(0.1, 2.0, N_GLOO).astype(np.float32)
    return torch.from_numpy(w), torch.from_numpy(bank)


def _gloo_workload(mesh):
    """What each rank and the local mesh run: one resampling, then a few
    tracker frames that resample on every tracked frame."""
    w, bank = _gloo_inputs()
    out = make_distributed_resampler(mesh, N_GLOO)(prng_key(9), shard_lanes(mesh, w),
                                                   shard_lanes(mesh, bank))
    d, args, markers = _golden()
    config = TrackerConfig(n_particles=N_GLOO, min_blob_area=8.0, pf_max_retries=8,
                           resample_min_ess=0.0)
    step = make_sharded_tracker(Camera.create(*args), torch.from_numpy(markers), ONES5, config,
                                mesh, device="cpu")
    state = shard_target_state(TargetState.create(N_GLOO, prng_key(0), device="cpu"), mesh)
    poses, flags = [], []
    for i in range(GLOO_FRAMES):
        frame = distributed.broadcast_frame(d["frames"][i], "cpu")
        state, res = step(state, frame, float(d["times"][i]))
        poses.append(res.pose.numpy())
        flags.append(int(res.fail_flag))
    return dict(resampled=out.resampled.numpy(), counts=out.counts.numpy(), most=int(out.most),
                clipped=int(out.clipped), poses=np.stack(poses), flags=np.asarray(flags),
                bank=state.bank.numpy(), weights=state.weights.numpy(),
                tracker_clipped=int(state.resample_clipped))


def _gloo_rank(rank: int, world: int, rendezvous: str, out_path: str) -> None:
    import torch.distributed as dist

    assert distributed.initialize_distributed(f"file://{rendezvous}", world, rank, "gloo") == rank
    try:
        mesh = distributed.make_pod_mesh()
        assert mesh.size == world and mesh.ranks == (rank,)
        np.savez(out_path, **_gloo_workload(mesh))
    finally:
        dist.destroy_process_group()


def test_two_gloo_ranks_equal_local_mesh(tmp_path):
    """Two processes over `gloo` (file rendezvous, so parallel test workers
    cannot collide), one shard each: each rank's resampler output and
    tracker state equal its shard of the local mesh's at P = 2, and the
    replicated results (most, clipped, poses, flags) are the same on both."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(HERE)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                                   if p]))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(N_RANKS),
                               str(tmp_path / "rendezvous"), str(tmp_path / f"rank{r}.npz")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(N_RANKS)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-3000:]}"
    want = _gloo_workload(LocalMesh(N_RANKS))
    assert want["clipped"] == 0 and want["tracker_clipped"] == 0
    assert (want["flags"][1:] == 10).all(), f"flags {want['flags']}"
    for r in range(N_RANKS):
        got = np.load(tmp_path / f"rank{r}.npz")
        for name in ("resampled", "counts", "bank", "weights"):
            np.testing.assert_array_equal(got[name][0], want[name][r], err_msg=f"rank {r} {name}")
        for name in ("most", "clipped", "poses", "flags", "tracker_clipped"):
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"rank {r} {name}")


if __name__ == "__main__":
    _gloo_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
