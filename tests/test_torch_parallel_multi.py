"""Targets x particles on the CPU: the port's `make_sharded_multi_tracker` on
a local mesh against its sequential multi-tracker, four `gloo` ranks (two
target groups of two shards, each group a `DistMesh` over its sub-group)
against the local mesh, and `run_multihost` in one process.

The scene is tests/test_torch_multi.py's: two targets on the 160x96
camera, the second with four markers padded to five.  The sharded tracker
sums weights per shard, then over shards, so it rounds differently from the
unsharded one: flags equal, pose and bank within atol = 1e-4, as
tests/test_torch_parallel_tracker.py holds the single target.  Four ranks
against the local mesh of the same shape must be EQUAL.  This file imports
no jax, so its ranks start quickly.

Run as a script this file is one rank of the four-rank test:
    python tests/test_torch_parallel_multi.py RANK WORLD RENDEZVOUS_FILE OUT.npz
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pf_monocular_pose_estimator_tpu_torch.geometry import Camera, exp_se3
from pf_monocular_pose_estimator_tpu_torch.io import demo_markers, render_frame, second_markers
from pf_monocular_pose_estimator_tpu_torch.parallel import (
    LocalMesh,
    distributed,
    make_mesh,
    make_sharded_multi_tracker,
    shard_target_state,
    unshard_target_state,
)
from pf_monocular_pose_estimator_tpu_torch.tracker import (
    create_states,
    make_multi_tracker,
    pad_marker_sets,
)
from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
CAMERA = dict(fx=150.0, fy=150.0, cx=80.0, cy=48.0, width=160, height=96)
N = 256
CONFIG = dict(n_particles=N, threshold_value=150.0, min_blob_area=3.0, pf_max_retries=4,
              max_detections=12, max_correspondence_candidates=8, roi_particle_subsample=16,
              init_cluster_radius=25.0, init_cluster_min=4, back_projection_pixel_tolerance=2.0,
              resample_min_ess=0.0)
# every block reaches every shard at P = 2 and whole blocks travel: no clipping
RING = dict(resample_reach=1, payload_window=None)
N_RANKS = 4  # 2 target groups x 2 particle shards
GLOO_FRAMES = 2


def _scene(n_frames: int):
    """tests/test_torch_multi.py's two-target scene: marker sets, masks and
    frames (n_frames, 96, 160)."""
    markers, masks = pad_marker_sets([demo_markers("cpu"), second_markers("cpu")[:4]])
    cam = Camera.create(**CAMERA)
    frames = []
    for i in range(n_frames):
        pa = exp_se3(torch.tensor([-0.25 + 0.004 * i, 0.0, 0.0, 0.1, -0.1, 0.05 + 0.01 * i]))
        pb = exp_se3(torch.tensor([0.25, 0.01 * i, 0.0, 0.2, -0.1, 0.1]))
        pa[2, 3] += 1.0
        pb[2, 3] += 1.1
        frame = sum(render_frame(cam, p, markers[k], 1.5, marker_mask=masks[k])
                    for k, p in enumerate((pa, pb)))
        frames.append(torch.clamp(frame, 0.0, 255.0))
    return cam, markers, masks, frames


def _sharded_replay(mesh, n_frames: int):
    """The sharded multi-tracker over the scene -> per frame (flags, poses,
    clipped), the last results and the last state."""
    cam, markers, masks, frames = _scene(n_frames)
    step = make_sharded_multi_tracker(cam, markers, masks, TrackerConfig(**CONFIG), mesh,
                                      device="cpu", **RING)
    state = shard_target_state(create_states(2, N, 0, (160, 96), device="cpu"), mesh,
                               batched=True)
    rows = []
    for i, frame in enumerate(frames):
        frame = distributed.broadcast_frame(frame.numpy(), "cpu")
        state, res = step(state, frame, 0.02 * (i + 1))
        rows.append((res.fail_flag.numpy(), res.pose.numpy(), res.resample_clipped.numpy()))
    return rows, res, state, step


def test_sharded_multi_tracker_matches_sequential():
    """make_mesh(2, target_shards=2): two targets, each bank over 2 shards,
    against the sequential multi-tracker over 4 frames (init, then PF frames
    that resample every frame): flags equal, pose and bank within 1e-4,
    nothing clipped, no sync added but the targets' own."""
    n_frames = 4
    mesh = make_mesh(2, target_shards=2)
    got, _, last, sharded = _sharded_replay(mesh, n_frames)
    assert last.bank.shape == (2, 2, 16, N // 2) and last.weights.shape == (2, 2, N // 2)
    cam, markers, masks, frames = _scene(n_frames)
    plain = make_multi_tracker(cam, markers, masks, TrackerConfig(**CONFIG), device="cpu")
    state = create_states(2, N, 0, (160, 96), device="cpu")
    for i, frame in enumerate(frames):
        state, res = plain(state, frame, 0.02 * (i + 1))
        flags, pose, clipped = got[i]
        np.testing.assert_array_equal(flags, res.fail_flag.numpy(), err_msg=f"frame {i}")
        np.testing.assert_allclose(pose, res.pose.numpy(), atol=1e-4, err_msg=f"frame {i}")
        assert (clipped == 0).all(), f"frame {i}: {clipped} draws clipped"
    assert (got[0][0] == 0).all() and (got[-1][0] == 10).all(), [g[0] for g in got]
    whole = unshard_target_state(last, mesh, batched=True)
    np.testing.assert_allclose(whole.bank.numpy(), state.bank.numpy(), atol=1e-4)
    assert sharded.host.count == plain.host.count, "sharding must add no device->host sync"


def test_pod_mesh_without_a_job_and_refusals():
    """One process: the pod mesh is one local shard holding every target
    group; targets must divide over the groups; observer poses are refused."""
    mesh = distributed.make_pod_mesh(target_devices=2)
    assert isinstance(mesh, LocalMesh) and mesh.size == 1 and mesh.target_shards == 2
    assert list(mesh.owned_targets(4)) == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="divide"):
        mesh.owned_targets(3)
    cam, markers, masks, _ = _scene(0)
    with pytest.raises(ValueError, match="use_cam_pos"):
        make_sharded_multi_tracker(cam, markers, masks, TrackerConfig(n_particles=64,
                                                                      use_cam_pos=True),
                                   make_mesh(2, 2), device="cpu")


def test_run_multihost_single_process(capsys):
    """The launcher's JSON line in one process (a local shard): the
    reference's keys, every frame tracked."""
    summary = distributed.run_multihost(["--particles", "512", "--frames", "3", "--device",
                                         "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == summary
    assert {"processes", "devices", "particles", "frames", "tracked", "fps"} <= set(line)
    assert line["processes"] == 1 and line["particles"] == 512 and line["frames"] == 3
    assert line["tracked"] == 3, line


# -------------------------------------------------------- four gloo ranks
def _gloo_workload(mesh) -> dict:
    rows, res, state, step = _sharded_replay(mesh, GLOO_FRAMES)
    whole = unshard_target_state(state, mesh, batched=True)
    return dict(flags=np.stack([r[0] for r in rows]), poses=np.stack([r[1] for r in rows]),
                clipped=np.stack([r[2] for r in rows]), covariance=res.covariance.numpy(),
                detections_xy=res.detections_xy.numpy(), used_bf=res.used_brute_force.numpy(),
                bank=state.bank.numpy(), weights=state.weights.numpy(),
                whole_bank=whole.bank.numpy(), whole_key=whole.key.numpy(),
                whole_updated=whole.pose_updated.numpy(), syncs=step.host.count)


def _gloo_rank(rank: int, world: int, rendezvous: str, out_path: str) -> None:
    import torch.distributed as dist

    assert distributed.initialize_distributed(f"file://{rendezvous}", world, rank, "gloo") == rank
    try:
        mesh = distributed.make_pod_mesh(target_devices=2)
        assert mesh.size == 2 and mesh.ranks == (rank % 2,) and mesh.target_index == rank // 2
        np.savez(out_path, **_gloo_workload(mesh))
    finally:
        dist.destroy_process_group()


def test_four_gloo_ranks_equal_local_mesh(tmp_path):
    """Four processes over `gloo` (file rendezvous), ranks 2g and 2g + 1
    holding target g's bank in two shards over their own sub-group: each
    rank's shard equals the local mesh's, and the results every rank gets
    from the job-wide gather (both targets) equal the local mesh's."""
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
    want = _gloo_workload(make_mesh(2, target_shards=2))
    assert (want["flags"][0] == 0).all() and (want["clipped"] == 0).all()
    for r in range(N_RANKS):
        got = np.load(tmp_path / f"rank{r}.npz")
        g, j = divmod(r, 2)
        np.testing.assert_array_equal(got["bank"][0, 0], want["bank"][g, j], err_msg=f"rank {r}")
        np.testing.assert_array_equal(got["weights"][0, 0], want["weights"][g, j])
        for name in ("flags", "poses", "clipped", "covariance", "detections_xy", "used_bf",
                     "whole_bank", "whole_key", "whole_updated"):
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"rank {r} {name}")
        # one target's syncs, plus the job-wide results gather each frame
        assert int(got["syncs"]) > GLOO_FRAMES


if __name__ == "__main__":
    _gloo_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
