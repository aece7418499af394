"""Free-running replays of the golden sequence with one occlusion and two
false detections, by the JAX tracker and by the port, on the CPU, and the
frame-0 init on faulted banks that decides them.

    python tests/fault_episodes.py [--particles 5000] [--seeds 0 1 2] [--frames 60]
        [--init-seeds 0 1 2 3 4 5 6 7] [--init-reference tests/golden/faults_init_reference.npz]

First, for each of `--init-seeds`, frame 0 of both trackers from the same
state: how far apart the two detectors' faulted detections are (in float32
ulps), and the reference's `initialise` + Gauss-Newton, jitted and op by op,
on the reference's detections and on the port's (the correspondences and the
pose error against the ground truth).  `--init-reference` writes the
reference's detections and the four outcomes (both evaluations, on its own
detections and on the port's, which lie one ulp away) to an npz that
chip_smoke.py holds the port's init on the card to.

Then, for each of `--seeds`, it prints per tracker the frame-0 pose error,
the tracked fraction, the median per-frame translation error, the ATE, the RMS
orientation error and the frames whose orientation error exceeds 10 deg; then
the pooled statistics of tests/test_robustness.py (mean and worst per-seed
orientation, median of the per-seed medians, pooled median orientation).
With false detections 1-5 px from real blobs, whether an init lands on the
right constellation is decided by rounding (see tests/test_torch_faults.py),
so the episodes a seed draws are the tracker's, not the port's; this script
shows which seeds draw them on each side.  The last line is one JSON object.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from pf_monocular_pose_estimator_tpu.geometry.camera import Camera as RefCamera  # noqa: E402
from pf_monocular_pose_estimator_tpu.tracker import TargetState as RefState  # noqa: E402
from pf_monocular_pose_estimator_tpu.tracker import make_tracker as ref_make_tracker  # noqa: E402
from pf_monocular_pose_estimator_tpu.utils import TrackerConfig as RefConfig  # noqa: E402
from pf_monocular_pose_estimator_tpu_torch.geometry import Camera  # noqa: E402
from pf_monocular_pose_estimator_tpu_torch.tracker import TargetState, make_tracker  # noqa: E402
from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig  # noqa: E402
from pf_monocular_pose_estimator_tpu_torch.utils.prng import prng_key  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "golden_sequence.npz")
FAULTS = dict(min_blob_area=8.0, pf_max_retries=8, number_of_occlusions=1,
              number_of_false_detections=2)


def angles_deg(est, gt):
    rel = np.einsum("tij,tkj->tik", est[:, :3, :3], gt[:, :3, :3])
    return np.degrees(np.arccos(np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1)))


def replay(side, d, n_particles, seed, n_frames):
    args = (float(d["fx"]), float(d["fy"]), float(d["cx"]), float(d["cy"]),
            np.asarray(d["dist"], np.float32), int(d["width"]), int(d["height"]))
    markers = np.concatenate([d["markers"], np.ones((5, 1), np.float32)], 1)
    config = dict(FAULTS, n_particles=n_particles)
    if side == "jax":
        step = ref_make_tracker(RefCamera.create(*args), jnp.asarray(markers), jnp.ones(5, bool),
                                RefConfig(**config))
        state = RefState.create(n_particles, jax.random.PRNGKey(seed))
        frame = lambda i: (jnp.asarray(d["frames"][i], jnp.float32), jnp.asarray(d["times"][i]))
    else:
        step = make_tracker(Camera.create(*args), torch.from_numpy(markers),
                            torch.ones(5, dtype=torch.bool), TrackerConfig(**config),
                            device="cpu")
        state = TargetState.create(n_particles, prng_key(seed), device="cpu")
        frame = lambda i: (torch.from_numpy(d["frames"][i]), float(d["times"][i]))
    poses, updated = [], []
    for i in range(n_frames):
        state, res = step(state, *frame(i))
        poses.append(np.asarray(res.pose))
        updated.append(bool(res.pose_updated))
    return np.stack(poses), np.asarray(updated)


def init_witness(seeds, path=None):
    """Frame 0 of both trackers per seed, and the reference's init on each
    detector's faulted detections (see tests/test_torch_faults.py)."""
    from test_torch_faults import N, _pose_gap, convert, faulted_setup

    f = faulted_setup()
    d = f["d"]
    evals = ("jit", "eager", "jit_shifted", "eager_shifted")
    out = {k: [] for k in ["seed", "xy", "mask"] + [f"{e}_{v}" for e in evals
                                                    for v in ("flag", "dfm", "pose")]}
    rows = []
    for seed in seeds:
        ref_state = RefState.create(N, jax.random.PRNGKey(seed))
        state = convert.state_from_reference(
            {k: (np.asarray(v) if k != "exposure" else v) for k, v in ref_state._asdict().items()})
        image = d["frames"][0]
        _, want = f["ref_step"](ref_state, jnp.asarray(image, jnp.float32),
                                jnp.asarray(d["times"][0]))
        _, got = f["step"](state, torch.from_numpy(image), float(d["times"][0]))
        xy_ref, mask = np.asarray(want.detections_xy), np.asarray(want.detections_mask)
        xy_port = got.detections_xy.numpy()
        ulps = np.abs(xy_port - xy_ref)[mask] / np.spacing(np.abs(xy_ref[mask]))
        row = dict(seed=seed, detections=int(mask.sum()),
                   injected=np.flatnonzero(np.asarray(want.detections_injected)).tolist(),
                   port_vs_reference_ulps=float(ulps.max()))
        port_mask = got.detections_mask.numpy()
        for source, xy, m in (("reference", xy_ref, mask), ("port", xy_port, port_mask)):
            for ev, (ok, flag, dfm, pose) in f["reference_inits"](xy, m, ref_state).items():
                mm, deg = _pose_gap(pose, d["poses"][0])
                row[f"{ev}_on_{source}"] = dict(flag=int(flag), dfm=dfm.tolist(),
                                                mm=float(mm) * 1e3 if ok else None,
                                                deg=float(deg) if ok else None)
                name = ev if source == "reference" else f"{ev}_shifted"
                out[f"{name}_flag"].append(int(flag))
                out[f"{name}_dfm"].append(dfm)
                out[f"{name}_pose"].append(pose)
        out["seed"].append(seed)
        out["xy"].append(xy_ref)
        out["mask"].append(mask)
        print(f"[init] {row}", flush=True)
        rows.append(row)
    if path:
        np.savez(path, **{k: np.asarray(v) for k, v in out.items()})
        print(f"[init] wrote {path}", flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--particles", type=int, default=5_000)
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--init-seeds", type=int, nargs="*", default=list(range(8)))
    ap.add_argument("--init-reference", default=None)
    a = ap.parse_args()
    torch.set_num_threads(4)
    d = np.load(GOLDEN)
    gt = d["poses"][:a.frames]
    out = {"particles": a.particles, "frames": a.frames,
           "init": init_witness(a.init_seeds, a.init_reference)}
    for side in ("jax", "port") if a.seeds else ():
        per_seed, angs, medians = [], [], []
        for seed in a.seeds:
            poses, upd = replay(side, d, a.particles, seed, a.frames)
            err = np.linalg.norm(poses[upd][:, :3, 3] - gt[upd][:, :3, 3], axis=-1)
            ang = angles_deg(poses[upd], gt[upd])
            ang0 = angles_deg(poses[:1], gt[:1])[0]
            row = dict(seed=seed, frame0_mm=float(np.linalg.norm(poses[0, :3, 3] - gt[0, :3, 3]))
                       * 1e3 if upd[0] else None, frame0_deg=float(ang0) if upd[0] else None,
                       tracked=float(upd.mean()), median_translation_mm=float(np.median(err)) * 1e3,
                       ate_mm=float(np.sqrt(np.mean(err ** 2))) * 1e3,
                       orientation_deg=float(np.sqrt(np.mean(ang ** 2))),
                       frames_over_10deg=np.flatnonzero(upd)[ang > 10].tolist())
            print(f"[{side}] {row}", flush=True)
            per_seed.append(row)
            angs.append(ang)
            medians.append(np.median(err))
        out[side] = dict(
            per_seed=per_seed, tracked=float(np.mean([r["tracked"] for r in per_seed])),
            median_of_medians_mm=float(np.median(medians)) * 1e3,
            pooled_median_orientation_deg=float(np.median(np.concatenate(angs))),
            mean_seed_orientation_deg=float(np.mean([r["orientation_deg"] for r in per_seed])),
            worst_seed_orientation_deg=float(max(r["orientation_deg"] for r in per_seed)))
        print(f"[{side}] pooled {({k: v for k, v in out[side].items() if k != 'per_seed'})}",
              flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
