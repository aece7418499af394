"""The benchmark's frozen plain reference (`portbench/reference/track.py`)
on the IPE track branch against the JAX tracker, on the CPU.

`Reference.step` with `configs/experiments/ipe_legacy.yaml`'s settings
(`use_particle_filter=False`, 64 particles, `min_blob_area` 8) is stepped
over the 20 golden frames of `tests/test_torch_ipe.py`, each frame from the
JAX tracker's state before it (converted to torch), and then over three
frames whose predicted pose is moved 3-5 cm with the track not yet mature,
so that the nearest-neighbour pairs fail the consensus check and both sides
take the brute-force fallback: two re-initialise (`INIT_SUCCESS`) and one
finds four LEDs in the moved ROI and fails (`HISTOGRAM_ALL_ZERO`).  Flags,
`pose_updated` and the track counter are equal; published poses lie within
`test_torch_ipe.py`'s bars (frame 0: 0.1 mm; every frame: 0.05 mm and 0.1
deg).  The rotation gap is the float64 chordal angle, which reads up to
~0.08 deg between rotations whose columns are ~1e-6 off unit length.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf_monocular_pose_estimator_tpu.geometry.camera import Camera as JaxCamera
from pf_monocular_pose_estimator_tpu.tracker import TargetState as JaxState
from pf_monocular_pose_estimator_tpu.tracker import make_tracker as jax_make_tracker
from pf_monocular_pose_estimator_tpu.utils import TrackerConfig as JaxConfig
from pf_monocular_pose_estimator_tpu_torch.utils import FailFlag

BENCH = Path(__file__).resolve().parents[1] / "portbench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from reference.track import Reference  # noqa: E402

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden_sequence.npz")
IPE = dict(use_particle_filter=False, n_particles=64, min_blob_area=8.0)
FRAMES = 20
# (frame, axis, metres the predicted pose moves) -> the flag both sides give
FALLBACKS = [((5, 0, 0.05), FailFlag.INIT_SUCCESS), ((12, 1, 0.04), FailFlag.INIT_SUCCESS),
             ((10, 0, 0.03), FailFlag.HISTOGRAM_ALL_ZERO)]


def as_reference_state(state: JaxState) -> SimpleNamespace:
    """The JAX tracker's state as the torch fields `Reference.step` reads."""
    out = {}
    for name, value in state._asdict().items():
        if name == "exposure":
            continue
        a = np.asarray(value)
        out[name] = torch.from_numpy(np.array(a.astype(np.int64) if a.dtype == np.uint32 else a))
    return SimpleNamespace(**out)


def pose_gap(p, q) -> tuple[float, float]:
    """(translation gap in m, chordal rotation gap in deg), in float64."""
    p, q = np.asarray(p, np.float64), np.asarray(q, np.float64)
    cos = np.clip((np.trace(p[:3, :3] @ q[:3, :3].T) - 1) / 2, -1, 1)
    return float(np.linalg.norm(p[:3, 3] - q[:3, 3])), float(np.degrees(np.arccos(cos)))


@pytest.fixture(scope="module")
def sides():
    d = dict(np.load(GOLDEN))
    args = (float(d["fx"]), float(d["fy"]), float(d["cx"]), float(d["cy"]),
            np.asarray(d["dist"], np.float32), int(d["width"]), int(d["height"]))
    markers = np.concatenate([d["markers"], np.ones((5, 1), np.float32)], 1)
    jax_step = jax_make_tracker(JaxCamera.create(*args), jnp.asarray(markers), jnp.ones(5, bool),
                                JaxConfig(**IPE))
    camera = dict(zip(("fx", "fy", "cx", "cy", "dist", "width", "height"), args))
    camera["dist"] = [float(x) for x in args[4]]
    ref = Reference(camera, markers, np.ones(5, bool), IPE, "cpu")
    states = [JaxState.create(64, jax.random.PRNGKey(0))]
    for i in range(FRAMES - 1):
        states.append(jax_step(states[-1], jnp.asarray(d["frames"][i], jnp.float32),
                               jnp.asarray(d["times"][i]))[0])
    return d, jax_step, ref, states


def step_both(sides, i: int, state: JaxState):
    d, jax_step, ref, _ = sides
    got, _ = ref.step(as_reference_state(state), torch.from_numpy(d["frames"][i]),
                      float(d["times"][i]))
    after, want = jax_step(state, jnp.asarray(d["frames"][i], jnp.float32),
                           jnp.asarray(d["times"][i]))
    return got, after, want


def assert_same_frame(got, after, want, bar_m: float, where: str):
    assert got.fail_flag == int(want.fail_flag), where
    assert got.pose_updated == bool(want.pose_updated), where
    assert got.it_since_initialized == int(after.it_since_initialized), where
    d_t, d_r = pose_gap(got.current_pose.numpy(), want.pose)
    assert d_t < bar_m, f"{where}: {d_t * 1e3:.5f} mm"
    assert d_r < 0.1, f"{where}: {d_r:.4f} deg"


def test_reference_ipe_replay_against_jax(sides):
    flags = []
    for i, state in enumerate(sides[3]):
        got, after, want = step_both(sides, i, state)
        flags.append(got.fail_flag)
        assert_same_frame(got, after, want, 1e-4 if i == 0 else 5e-5, f"frame {i}")
    assert flags == [int(FailFlag.INIT_SUCCESS)] + [int(FailFlag.PF_SUCCESS)] * (FRAMES - 1)


@pytest.mark.parametrize("moved,flag", FALLBACKS,
                         ids=[f"frame{f}_axis{a}_{int(m * 100)}cm" for (f, a, m), _ in FALLBACKS])
def test_reference_ipe_fallback_against_jax(sides, moved, flag):
    i, axis, metres = moved
    state = sides[3][i]
    pred = np.array(state.predicted_pose)
    pred[axis, 3] += metres
    state = state._replace(predicted_pose=jnp.asarray(pred),
                           it_since_initialized=jnp.asarray(1, jnp.int32))
    got, after, want = step_both(sides, i, state)
    assert got.fail_flag == int(flag)
    assert_same_frame(got, after, want, 5e-5, f"frame {i} moved {metres} m")
