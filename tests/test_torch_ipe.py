"""The IPE track branch (`use_particle_filter=False`, the reference's
`ipe_track_branch`): the port's tracker against the JAX tracker over 20
golden frames with `configs/experiments/ipe_legacy.yaml`'s settings."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pf_monocular_pose_estimator_tpu.geometry.camera import Camera as RefCamera
from pf_monocular_pose_estimator_tpu.tracker import TargetState as RefState
from pf_monocular_pose_estimator_tpu.tracker import make_tracker as ref_make_tracker
from pf_monocular_pose_estimator_tpu.utils import TrackerConfig as RefConfig
from pf_monocular_pose_estimator_tpu_torch.geometry import Camera
from pf_monocular_pose_estimator_tpu_torch.tracker import TargetState, make_tracker
from pf_monocular_pose_estimator_tpu_torch.utils import FailFlag, TrackerConfig
from pf_monocular_pose_estimator_tpu_torch.utils.prng import prng_key

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden_sequence.npz")
IPE = dict(use_particle_filter=False, n_particles=64, min_blob_area=8.0)


def test_ipe_replay_against_jax():
    """Flags and `pose_updated` equal frame for frame; poses within
    tests/test_torch_tracker.py's bars (frame 0: 0.1 mm; every frame: 0.05
    mm and 0.1 deg).  The branch is the reference's: frame 0 initialises,
    every later frame tracks (flag 10) without re-initialising."""
    d = dict(np.load(GOLDEN))
    args = (float(d["fx"]), float(d["fy"]), float(d["cx"]), float(d["cy"]),
            np.asarray(d["dist"], np.float32), int(d["width"]), int(d["height"]))
    markers = np.concatenate([d["markers"], np.ones((5, 1), np.float32)], 1)
    ref_step = ref_make_tracker(RefCamera.create(*args), jnp.asarray(markers), jnp.ones(5, bool),
                                RefConfig(**IPE))
    step = make_tracker(Camera.create(*args), torch.from_numpy(markers),
                        torch.ones(5, dtype=torch.bool), TrackerConfig(**IPE), device="cpu")
    ref_state = RefState.create(64, jax.random.PRNGKey(0))
    state = TargetState.create(64, prng_key(0), device="cpu")
    flags = []
    for i in range(20):
        ref_state, want = ref_step(ref_state, jnp.asarray(d["frames"][i], jnp.float32),
                                   jnp.asarray(d["times"][i]))
        state, got = step(state, torch.from_numpy(d["frames"][i]), float(d["times"][i]))
        flags.append(int(got.fail_flag))
        assert int(got.fail_flag) == int(want.fail_flag), f"frame {i}"
        assert bool(got.pose_updated) == bool(want.pose_updated), f"frame {i}"
        p, q = got.pose.numpy(), np.asarray(want.pose)
        d_t = np.linalg.norm(p[:3, 3] - q[:3, 3])
        assert d_t < (1e-4 if i == 0 else 5e-5), f"frame {i}: {d_t * 1e3:.4f} mm"
        cos = np.clip((np.trace(p[:3, :3] @ q[:3, :3].T) - 1) / 2, -1, 1)
        assert np.degrees(np.arccos(cos)) < 0.1, f"frame {i}"
    assert flags == [int(FailFlag.INIT_SUCCESS)] + [int(FailFlag.PF_SUCCESS)] * 19
    assert int(state.it_since_initialized) == int(ref_state.it_since_initialized) == 2
    # syncs: counters, ROI, count, the consensus check
    assert step.host.count / step.frames <= 4.0
