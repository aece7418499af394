"""The `debug_skip` stages against the JAX tracker: "resample" (keep the
bank, refine the argmax lane), "propagate" (keep the resampled bank) and
"weight" (a constant-plus-|R00| weight), each over the first golden
frames.  Each port frame starts from the reference's state before it
(converted): with the weight skipped the filter's choices are ties broken
by rounding, which a free-running comparison would let compound.  A
skipped stage takes the tracker off the fused kernel onto the
torch propagation and weight, as the reference leaves its fused kernel."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf_monocular_pose_estimator_tpu.geometry.camera import Camera as RefCamera
from pf_monocular_pose_estimator_tpu.tracker import TargetState as RefState
from pf_monocular_pose_estimator_tpu.tracker import make_tracker as ref_make_tracker
from pf_monocular_pose_estimator_tpu.utils import TrackerConfig as RefConfig
from pf_monocular_pose_estimator_tpu_torch.geometry import Camera
from pf_monocular_pose_estimator_tpu_torch.tracker import make_tracker
from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig, convert

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden_sequence.npz")
N = 2_000
FRAMES = 4  # init, then three PF frames that each resample


@pytest.mark.parametrize("stage", ["resample", "propagate", "weight"])
def test_debug_skip_stage_against_jax(stage, monkeypatch):
    """Same flags and poses within 0.05 mm and 0.1 deg on every frame
    (tests/test_torch_tracker.py's bars); the fused pass is never called;
    with "resample" the resampled bank is the propagated one, and with
    "propagate" the bank is the previous frame's resampled bank."""
    d = np.load(GOLDEN)
    args = (float(d["fx"]), float(d["fy"]), float(d["cx"]), float(d["cy"]),
            np.asarray(d["dist"], np.float32), int(d["width"]), int(d["height"]))
    markers = np.concatenate([d["markers"], np.ones((5, 1), np.float32)], 1)
    # "resample" and "propagate" resample every tracked frame, so the skip
    # is what keeps (or moves) the bank.  With the weight skipped the
    # weights are ~31 +- 0.5 on every lane, so a forced resampling's
    # most-drawn lane is a tie broken by 1-ulp differences in the weights
    # (XLA contracts the reference's noise affine into an FMA on the CPU,
    # the port rounds the product); the default ESS gate keeps the
    # argmax lane instead, which both sides agree on.
    ess = 0.15 if stage == "weight" else 0.0
    cfg = dict(n_particles=N, min_blob_area=8.0, pf_max_retries=4, resample_min_ess=ess,
               debug_skip=(stage,))
    ref_step = ref_make_tracker(RefCamera.create(*args), jnp.asarray(markers), jnp.ones(5, bool),
                                RefConfig(**cfg))
    step = make_tracker(Camera.create(*args), torch.from_numpy(markers),
                        torch.ones(5, dtype=torch.bool), TrackerConfig(**cfg), device="cpu")
    fused = []
    if stage != "resample":
        monkeypatch.setattr("pf_monocular_pose_estimator_tpu_torch.tracker.step."
                            "fused_propagate_weight", lambda *a, **k: fused.append(1))
    ref_state = RefState.create(N, jax.random.PRNGKey(0))
    for i in range(FRAMES):
        state = convert.state_from_reference(
            {n: (np.asarray(v) if n != "exposure" else v) for n, v in ref_state._asdict().items()})
        before = state.resampled
        ref_state, want = ref_step(ref_state, jnp.asarray(d["frames"][i], jnp.float32),
                                   jnp.asarray(d["times"][i]))
        state, got = step(state, torch.from_numpy(d["frames"][i]), float(d["times"][i]))
        assert int(got.fail_flag) == int(want.fail_flag), f"frame {i}"
        assert bool(got.pose_updated) == bool(want.pose_updated), f"frame {i}"
        p, q = got.pose.numpy(), np.asarray(want.pose)
        d_t = np.linalg.norm(p[:3, 3] - q[:3, 3])
        assert d_t < (1e-4 if i == 0 else 5e-5), f"frame {i}: {d_t * 1e3:.4f} mm"
        cos = np.clip((np.trace(p[:3, :3] @ q[:3, :3].T) - 1) / 2, -1, 1)
        assert np.degrees(np.arccos(cos)) < 0.1, f"frame {i}"
        if i > 0 and stage == "resample":
            assert torch.equal(state.resampled, state.bank)
        if i > 0 and stage == "propagate":
            assert torch.equal(state.bank, before)
    assert not fused
