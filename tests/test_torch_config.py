"""Config, flags, dynamic parameters and state conversion: the port's
copies against the JAX package, plus the rule that the port never imports
jax (a static scan: this interpreter imports jax at startup, so
`sys.modules` cannot tell)."""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf_monocular_pose_estimator_tpu.ops.blob import BlobParams as RefBlobParams
from pf_monocular_pose_estimator_tpu.tracker.state import TargetState as RefState
from pf_monocular_pose_estimator_tpu.utils.config import TrackerConfig as RefConfig
from pf_monocular_pose_estimator_tpu.utils.dynamic import DynamicParams as RefDynamic
from pf_monocular_pose_estimator_tpu.utils.flags import FailFlag as RefFlag
from pf_monocular_pose_estimator_tpu_torch.geometry import Camera
from pf_monocular_pose_estimator_tpu_torch.tracker import TargetState, make_tracker
from pf_monocular_pose_estimator_tpu_torch.utils import (
    BlobParams,
    DynamicParams,
    FailFlag,
    TrackerConfig,
)
from pf_monocular_pose_estimator_tpu_torch.utils import convert

torch.set_num_threads(2)

PORT = Path(__file__).resolve().parent.parent / "pf_monocular_pose_estimator_tpu_torch"


def test_tracker_config_fields_and_defaults_equal():
    ref = {f.name: f.default for f in dataclasses.fields(RefConfig)}
    got = {f.name: f.default for f in dataclasses.fields(TrackerConfig)}
    assert got == ref
    assert dataclasses.asdict(TrackerConfig.reference_parity()) == dataclasses.asdict(
        RefConfig.reference_parity())
    cfg = TrackerConfig(min_blob_area=8.0, split_merged_blobs=False)
    ref_bp = RefConfig(min_blob_area=8.0, split_merged_blobs=False).blob_params()
    assert tuple(cfg.blob_params()) == tuple(ref_bp)
    assert BlobParams._fields == RefBlobParams._fields
    assert tuple(BlobParams()) == tuple(RefBlobParams())


def test_fail_flag_codes_equal():
    assert {f.name: int(f) for f in FailFlag} == {f.name: int(f) for f in RefFlag}


def test_dynamic_params_from_config_equal():
    cfg = dict(threshold_value=200.0, back_projection_pixel_tolerance_pf=7.5)
    ref = RefDynamic.from_config(RefConfig(**cfg))
    got = DynamicParams.from_config(TrackerConfig(**cfg))
    assert [f.name for f in dataclasses.fields(DynamicParams)] == list(RefDynamic._fields)
    for name in RefDynamic._fields:
        assert float(getattr(got, name)) == float(np.asarray(getattr(ref, name))), name


def test_port_never_imports_jax():
    pattern = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+pf_monocular_pose_estimator_tpu\b"
                         r"|from\s+pf_monocular_pose_estimator_tpu(\.|\s))", re.M)
    sources = sorted(PORT.rglob("*.py"))
    assert len(sources) >= 20
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    smoke = PORT.parent / "chip_smoke.py"
    if pattern.search(smoke.read_text()):
        offenders.append(str(smoke))
    # the root scripts of the port: nor `benchmarks/`, `bench.py` or chip_smoke.py
    for script in ("bench_torch.py", "accuracy_torch.py", "sweep_torch.py"):
        text = (PORT.parent / script).read_text()
        if pattern.search(text) or re.search(r"^\s*(import|from)\s+(bench|benchmarks|chip_smoke)\b",
                                             text, re.M):
            offenders.append(script)
    assert not offenders, offenders


def test_sharded_tracker_refuses_observer_poses():
    """The sharded step takes no observer pose (nor does the reference's), so
    `use_cam_pos=True` raises there instead of tracking without ego-motion."""
    from pf_monocular_pose_estimator_tpu_torch.parallel import make_mesh, make_sharded_tracker

    cam = Camera.create(400.0, 400.0, 376.0, 240.0)
    markers = torch.cat([torch.rand(5, 3), torch.ones(5, 1)], 1)
    with pytest.raises(ValueError, match="use_cam_pos"):
        make_sharded_tracker(cam, markers, torch.ones(5, dtype=torch.bool),
                             TrackerConfig(n_particles=64, use_cam_pos=True), make_mesh(2),
                             device="cpu")


@pytest.mark.parametrize(
    "override",
    [
        dict(use_pallas_resample=True),
        dict(use_closed_form_resample=True),
        dict(use_fused_pf_kernel=False),
        dict(use_folded_pf_kernel=False),
        dict(use_pallas_gn=False),
        dict(use_particle_filter=False),
        dict(number_of_occlusions=1),
        dict(number_of_false_detections=2),
        dict(use_online_exposure_control=True),
        dict(use_cam_pos=True),
        dict(debug_skip=("resample",)),
        dict(debug_skip=("propagate",)),
        dict(debug_skip=("weight",)),
    ],
)
def test_ported_switches_run(override):
    """Each option builds a tracker on the CPU and tracks the first two
    golden frames (init, then a frame that resamples, or the IPE branch).
    With one occlusion the first init fails, as the JAX tracker's does on
    these frames (its vote histogram is empty: flag 120), so that option
    tracks frames 1 and 2."""
    d = np.load(PORT.parent / "tests" / "golden" / "golden_sequence.npz")
    cam = Camera.create(float(d["fx"]), float(d["fy"]), float(d["cx"]), float(d["cy"]),
                        np.asarray(d["dist"], np.float32), int(d["width"]), int(d["height"]))
    markers = torch.from_numpy(np.concatenate([d["markers"], np.ones((5, 1), np.float32)], 1))
    config = TrackerConfig(n_particles=2048, min_blob_area=8.0, pf_max_retries=2,
                           resample_min_ess=0.0, **override)
    step = make_tracker(cam, markers, torch.ones(5, dtype=torch.bool), config, device="cpu")
    state = TargetState.create(2048, device="cpu")
    first = 1 if config.number_of_occlusions else 0
    for i in range(first + 2):
        state, res = step(state, torch.from_numpy(d["frames"][i]), float(d["times"][i]))
        if i < first:
            assert int(res.fail_flag) == int(FailFlag.HISTOGRAM_ALL_ZERO)
        else:
            assert bool(res.pose_updated), f"frame {i} not updated"
    assert np.isfinite(res.pose.numpy()).all()


def test_entry_points_default_to_the_card():
    """make_tracker and TargetState.create place their tensors on "cuda"
    unless asked for the CPU; without a card they raise, never fall back."""
    cam = Camera.create(400.0, 400.0, 376.0, 240.0)
    markers = torch.cat([torch.rand(5, 3), torch.ones(5, 1)], 1)
    mask = torch.ones(5, dtype=torch.bool)
    config = TrackerConfig(n_particles=64)
    if torch.cuda.is_available():
        assert make_tracker(cam, markers, mask, config).device.type == "cuda"
        assert TargetState.create(64).bank.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            make_tracker(cam, markers, mask, config)
        with pytest.raises((AssertionError, RuntimeError)):
            TargetState.create(64)


def test_camera_markers_dynamic_converters():
    from pf_monocular_pose_estimator_tpu.geometry.camera import Camera as RefCamera

    ref_cam = RefCamera.create(420.0, 418.5, 376.25, 240.5, [-0.3, 0.1, 1e-3, -5e-4, 0.0])
    cam = convert.camera_from_reference({k: np.asarray(v) for k, v in ref_cam._asdict().items()})
    for name in ("fx", "fy", "cx", "cy", "dist"):
        np.testing.assert_array_equal(getattr(cam, name).numpy(), np.asarray(getattr(ref_cam, name)))
    assert (cam.width, cam.height) == (ref_cam.width, ref_cam.height)
    ref_dyn = RefDynamic.from_config(RefConfig(threshold_value=222.0))
    dyn = convert.dynamic_from_reference({k: np.asarray(v) for k, v in ref_dyn._asdict().items()})
    for name in RefDynamic._fields:
        assert float(getattr(dyn, name)) == float(np.asarray(getattr(ref_dyn, name))), name
    markers, mask = convert.markers_from_reference(np.ones((5, 4)), [True] * 4 + [False])
    assert markers.dtype == torch.float32 and mask.dtype == torch.bool and not bool(mask[4])


def test_state_round_trip_every_field():
    rng = np.random.default_rng(0)
    ref = RefState.create(64, jax.random.PRNGKey(11))
    # non-default values in every leaf so a dropped or swapped field shows
    leaves, treedef = jax.tree_util.tree_flatten(ref)
    noisy = []
    for leaf in leaves:
        a = np.asarray(leaf)
        if a.dtype == np.float32:
            a = a + rng.normal(size=a.shape).astype(np.float32)
        elif a.dtype == np.int32:
            a = a + rng.integers(1, 50, size=a.shape).astype(np.int32)
        elif a.dtype == bool:
            a = ~a
        noisy.append(jnp.asarray(a))
    ref = jax.tree_util.tree_unflatten(treedef, noisy)
    fields = {k: np.asarray(v) if k != "exposure" else v for k, v in ref._asdict().items()}
    port = convert.state_from_reference(fields)
    assert isinstance(port, TargetState)
    assert port.key.dtype == torch.int64 and port.key.device.type == "cpu"
    back = convert.state_to_reference(port)
    for name, value in ref._asdict().items():
        if name == "exposure":
            for got, want in zip(back["exposure"], value):
                np.testing.assert_array_equal(got, np.asarray(want))
                assert got.dtype == np.asarray(want).dtype
            continue
        np.testing.assert_array_equal(back[name], np.asarray(value), err_msg=name)
        assert back[name].dtype == np.asarray(value).dtype, name
