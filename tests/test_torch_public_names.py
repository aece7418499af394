"""The port's public names against the reference's, and each function the
port added last against the JAX one.

Parity: every name in each reference subpackage's `__all__` imports from
the port's subpackage of the same name, and every public function or class
defined in a reference module exists in the port's module of the same
name.  Each `pallas_*` module maps to its `*_kernel` counterpart, function
by function.  The exemptions, each with its reason, are `EXEMPT`.

Per function: `pack`, `pack_single`, `identity_bank16`,
`connected_components` and the AoS `propagate`'s draws bit for bit;
`compose`, `rotation_rpy`, `project_points` and `project_soa` within
float32 rounding (XLA contracts multiply-adds on the CPU, and its sin / cos
may differ by an ulp: rtol 2e-6, atol 2e-6 for entries of order one,
1e-4 px for pixels of order 400); `tracker_step` over 5 golden frames
against the reference's, with tests/test_torch_tracker.py's bars."""

import ast
import importlib
import inspect
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pf_monocular_pose_estimator_tpu as ref_pkg
from pf_monocular_pose_estimator_tpu.geometry import camera as ref_camera_mod
from pf_monocular_pose_estimator_tpu.geometry import se3 as ref_se3
from pf_monocular_pose_estimator_tpu.ops import blob as ref_blob
from pf_monocular_pose_estimator_tpu.pf import soa as ref_soa
from pf_monocular_pose_estimator_tpu.tracker import TargetState as RefState
from pf_monocular_pose_estimator_tpu.tracker import tracker_step as ref_tracker_step
from pf_monocular_pose_estimator_tpu.utils import TrackerConfig as RefConfig
from pf_monocular_pose_estimator_tpu_torch import geometry, ops, pf, tracker
from pf_monocular_pose_estimator_tpu_torch.pf import soa
from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig
from pf_monocular_pose_estimator_tpu_torch.utils.prng import prng_key

torch.set_num_threads(2)
ref_propagate = importlib.import_module("pf_monocular_pose_estimator_tpu.pf.propagate")

REF = Path(ref_pkg.__file__).parent
PORT = "pf_monocular_pose_estimator_tpu_torch"
SUBPACKAGES = sorted(p.parent.name for p in REF.glob("*/__init__.py"))
MODULES = sorted(str(p.relative_to(REF).with_suffix("")) for p in REF.glob("*/*.py")
                 if p.name != "__init__.py")

# Reference names with no counterpart, by design.
EXEMPT = {
    "parallel/pf_kernels.py::replicated": "a jax.shard_map wrapper that runs a replicated "
                                          "kernel under manual sharding; PyTorch has no SPMD "
                                          "partitioner to keep away from it",
    "utils/compile_cache.py": "the XLA persistent compilation cache; PyTorch runs eagerly and "
                              "the kernels are built once into build/torch_kernels/ "
                              "(utils/cuda_lib.py::cached_build); bench_torch.py --no-cache, "
                              "the counterpart of bench.py's, builds them cold into a "
                              "temporary directory instead",
}
# pallas_* module -> its *_kernel counterpart, and each public function's
# counterpart there ("module:name" where it lives elsewhere).
PALLAS = {
    "ops/pallas_kernels": ("ops/detect_kernel", {"detect_stats_pallas": "detect_stats",
                                                 "threshold_blur_pallas": "threshold_blur"}),
    "pf/pallas_gather": ("pf/gather_kernel", {"monotone_gather_pallas": "windowed_gather",
                                              "monotone_gather": "monotone_gather"}),
    "pf/pallas_refine": ("pf/refine_kernel",
                         {"gauss_newton_refine_pallas": "gauss_newton_refine_batched"}),
    "pf/pallas_resample": ("pf/resample_kernel", {"probe_rank": "probe_rank",
                                                  "resample_bank_pallas": "resample_bank"}),
    "pf/pallas_step": ("pf/step_kernel", {
        "fused_propagate_weight_pallas": "fused_propagate_weight",
        "bank_top_pin": "resample_gather", "bank_restore_pin": "resample_gather",
        "bank_layout_pin": "parallel/gather_kernel:ring_gather"}),
    "pf/pallas_weight": ("pf/weight_kernel", {"weight_particles_pallas": "weight_particles_bank"}),
}


def _public_defs(path: Path) -> list:
    tree = ast.parse(path.read_text())
    return sorted(n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                  and not n.name.startswith("_"))


def _all(path: Path) -> list:
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", "") == "__all__"
                                                for t in node.targets):
            return list(ast.literal_eval(node.value))
    return []


def _port(module: str):
    return importlib.import_module(f"{PORT}.{module.replace('/', '.')}")


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_the_reference_names(sub):
    names = _all(REF / sub / "__init__.py")
    assert names, sub
    port = _port(sub)
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, f"{sub}: {missing}"
    assert set(names) <= set(port.__all__), f"{sub}: not in __all__"


@pytest.mark.parametrize("module", MODULES)
def test_module_has_every_public_definition(module):
    if f"{module}.py" in EXEMPT:
        assert not (Path(_port_path(module))).exists()
        return
    name = Path(module).name
    if name.startswith("pallas_"):
        target, names = PALLAS[module]
        assert sorted(names) == _public_defs(REF / f"{module}.py"), "unmapped Pallas function"
        for ref_name, port_name in names.items():
            mod, _, fn = port_name.rpartition(":")
            assert hasattr(_port(mod or target), fn), f"{module}.{ref_name} -> {port_name}"
        return
    port = _port(module)
    missing = [n for n in _public_defs(REF / f"{module}.py")
               if not hasattr(port, n) and f"{module}.py::{n}" not in EXEMPT]
    assert not missing, f"{module}: {missing}"


def _port_path(module: str) -> str:
    return os.path.join(os.path.dirname(geometry.__file__), "..", f"{module}.py")


def test_exemptions_are_few_and_real():
    assert len(EXEMPT) == 2 and all(len(reason) > 40 for reason in EXEMPT.values())
    assert "replicated" in _public_defs(REF / "parallel" / "pf_kernels.py")
    assert (REF / "utils" / "compile_cache.py").exists()
    assert "directory" in inspect.signature(_port("utils/cuda_lib").cached_build).parameters
    assert "--no-cache" in (REF.parent / "bench_torch.py").read_text()
    assert not hasattr(_port("parallel/pf_kernels"), "replicated")


# ---------------------------------------------------------------- functions
def _rng_poses(rng, n):
    tw = jnp.asarray(rng.normal(0, 0.3, (n, 6)), jnp.float32)
    poses = np.array(jax.vmap(ref_se3.exp_se3)(tw))
    poses[:, 2, 3] += 1.5
    return poses


def test_pack_pack_single_identity_bank16_exact():
    rng = np.random.default_rng(0)
    bank = _rng_poses(rng, 37)
    np.testing.assert_array_equal(soa.pack(torch.from_numpy(bank)).numpy(),
                                  np.asarray(ref_soa.pack(jnp.asarray(bank))))
    np.testing.assert_array_equal(soa.pack_single(torch.from_numpy(bank[3])).numpy(),
                                  np.asarray(ref_soa.pack_single(jnp.asarray(bank[3]))))
    np.testing.assert_array_equal(soa.unpack(soa.pack(torch.from_numpy(bank))).numpy(), bank)
    got = soa.identity_bank16(11)
    assert got.dtype == torch.float32 and got.shape == (16, 11)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_soa.identity_bank16(11)))


@pytest.mark.parametrize("sweeps", [0, 1, 5, 12, 20])
def test_connected_components_exact(sweeps):
    rng = np.random.default_rng(sweeps)
    fg = rng.random((40, 57)) < 0.35
    fg[10:14, :] = True  # a band longer than the sweeps reach
    want = np.asarray(ref_blob.connected_components(jnp.asarray(fg), sweeps))
    got = ops.connected_components(torch.from_numpy(fg), sweeps)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


NOISE = dict(min_translation=-0.01, max_translation=0.02, min_angular=-0.02, max_angular=0.015)


def _propagate_args(rng, n, tracking, apply_prediction, identity, unit=False):
    bank = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1)) if identity else _rng_poses(rng, n)
    poses = [_rng_poses(rng, 1)[0] for _ in range(4)]
    for p in poses[2:]:  # the prediction and the ego-motion: near the identity
        p[2, 3] -= 1.5
    ones = np.ones(3, np.float32)
    return (bank, *poses, ones if unit else np.float32([0.3, 0.5, 0.7]),
            ones if unit else np.float32([0.2, 0.2, 0.4]), tracking, apply_prediction,
            np.float32(1.0 if unit else 1.05))


def _run_propagate(args, seed, noise=NOISE):
    bank, cur, pred, predm, cmi, fac_t, fac_r, tracking, apply_pred, infl = args
    want = ref_propagate.propagate(
        jax.random.PRNGKey(seed), jnp.asarray(bank), jnp.asarray(cur), jnp.asarray(pred),
        jnp.asarray(predm), jnp.asarray(cmi), ref_propagate.NoiseBounds(**noise),
        jnp.asarray(fac_t), jnp.asarray(fac_r), jnp.asarray(tracking),
        jnp.asarray(apply_pred), jnp.asarray(infl))
    t = torch.from_numpy
    got = pf.propagate(prng_key(seed), t(bank), t(cur), t(pred), t(predm), t(cmi),
                       pf.NoiseBounds(**noise), t(fac_t), t(fac_r), tracking, apply_pred,
                       float(infl))
    return got.numpy(), np.asarray(want)


def test_propagate_aos_draws_exact():
    """Identity bank, not tracking, noise bounds [0, 1) with unit factors:
    the translation column is the draws themselves (0 + u), which must equal
    the reference's bit for bit (with other bounds XLA on the CPU contracts
    jax's affine into an FMA: tests/test_torch_prng.py pins both roundings);
    the rotation block is Rz @ Ry @ Rx of the drawn angles."""
    rng = np.random.default_rng(1)
    unit = dict(min_translation=0.0, max_translation=1.0, min_angular=0.0, max_angular=1.0)
    got, want = _run_propagate(_propagate_args(rng, 1000, False, False, True, unit=True), 7,
                               unit)
    np.testing.assert_array_equal(got[2:, :3, 3], want[2:, :3, 3])
    np.testing.assert_array_equal(got[:2], want[:2])  # the pinned poses
    np.testing.assert_allclose(got[:, :3, :3], want[:, :3, :3], rtol=2e-6, atol=2e-6)
    assert want[2:, :3, 3].min() < 0.01 and want[2:, :3, 3].max() > 0.99  # the draws span [0, 1)


@pytest.mark.parametrize("tracking,apply_prediction", [(True, True), (True, False)])
def test_propagate_aos_matches_reference(tracking, apply_prediction):
    rng = np.random.default_rng(2)
    got, want = _run_propagate(_propagate_args(rng, 500, tracking, apply_prediction, False), 3)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


def test_compose_and_rotation_rpy_match_reference():
    rng = np.random.default_rng(3)
    a, b = _rng_poses(rng, 9), _rng_poses(rng, 9)
    np.testing.assert_allclose(geometry.compose(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(ref_se3.compose(jnp.asarray(a), jnp.asarray(b))),
                               rtol=2e-6, atol=2e-6)
    angles = rng.uniform(-3.5, 3.5, (4, 7, 3)).astype(np.float32)
    got = geometry.rotation_rpy(torch.from_numpy(angles)).numpy()
    want = np.asarray(ref_se3.rotation_rpy(jnp.asarray(angles)))
    assert got.shape == (4, 7, 4, 4)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    np.testing.assert_array_equal(got[..., 3, :], want[..., 3, :])


def test_project_points_and_project_soa_match_reference():
    rng = np.random.default_rng(4)
    cam = dict(fx=420.0, fy=418.0, cx=376.0, cy=240.0)
    ref_cam = ref_camera_mod.Camera.create(**cam)
    port_cam = geometry.Camera.create(**cam)
    poses = _rng_poses(rng, 6)
    pts = rng.normal(0, 0.1, (6, 5, 3)).astype(np.float32)
    got = geometry.project_points(port_cam, torch.from_numpy(poses), torch.from_numpy(pts))
    want = ref_camera_mod.project_points(ref_cam, jnp.asarray(poses), jnp.asarray(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    markers = np.concatenate([pts[0], np.ones((5, 1), np.float32)], 1)
    bank16 = ref_soa.pack(jnp.asarray(_rng_poses(rng, 300)))
    want = ref_soa.project_soa(ref_cam, bank16, jnp.asarray(markers))
    got = soa.project_soa(port_cam, torch.from_numpy(np.array(bank16)),
                          torch.from_numpy(markers))
    assert got.shape == (5, 2, 300)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


# ---------------------------------------------------------------- tracker_step
GOLDEN_FRAMES = 5
STEP_CONFIG = dict(n_particles=5_000, min_blob_area=8.0, pf_max_retries=8)


def test_tracker_step_matches_reference_on_golden_frames():
    """The functional `tracker_step` over the first golden frames, free
    running on both sides, with tests/test_torch_tracker.py's bars: flags
    and updates equal, frame 0 within 0.1 mm, the rest within 0.05 mm and
    0.1 deg; one `Tracker` is built for the five calls."""
    d = np.load(os.path.join(os.path.dirname(__file__), "golden", "golden_sequence.npz"))
    args = (float(d["fx"]), float(d["fy"]), float(d["cx"]), float(d["cy"]),
            np.asarray(d["dist"], np.float32), int(d["width"]), int(d["height"]))
    markers = np.concatenate([d["markers"], np.ones((5, 1), np.float32)], 1)
    ref_cam, cam = ref_camera_mod.Camera.create(*args), geometry.Camera.create(*args)
    ref_cfg, cfg = RefConfig(**STEP_CONFIG), TrackerConfig(**STEP_CONFIG)
    mask = np.ones(5, bool)
    ref_step = jax.jit(lambda s, img, t: ref_tracker_step(s, img, t, ref_cam,
                                                           jnp.asarray(markers),
                                                           jnp.asarray(mask), ref_cfg))
    ref_state = RefState.create(STEP_CONFIG["n_particles"], jax.random.PRNGKey(0))
    state = tracker.TargetState.create(STEP_CONFIG["n_particles"], prng_key(0), device="cpu")
    tracker.step._STEP_CACHE.clear()
    for i in range(GOLDEN_FRAMES):
        ref_state, want = ref_step(ref_state, jnp.asarray(d["frames"][i], jnp.float32),
                                   jnp.asarray(d["times"][i]))
        state, got = tracker.tracker_step(state, torch.from_numpy(d["frames"][i]),
                                          float(d["times"][i]), cam, torch.from_numpy(markers),
                                          torch.from_numpy(mask), cfg)
        assert int(got.fail_flag) == int(want.fail_flag), f"frame {i}"
        assert bool(got.pose_updated) and bool(want.pose_updated), f"frame {i}"
        a, b = got.pose.numpy(), np.asarray(want.pose)
        rel = a[:3, :3] @ b[:3, :3].T
        ang = np.degrees(np.arccos(np.clip((np.trace(rel) - 1) / 2, -1, 1)))
        d_t = np.linalg.norm(a[:3, 3] - b[:3, 3])
        assert d_t < (1e-4 if i == 0 else 5e-5) and ang < 0.1, f"frame {i}: {d_t}, {ang}"
    assert len(tracker.step._STEP_CACHE) == 1


def test_tracker_step_refuses_the_spmd_hooks():
    state = tracker.TargetState.create(8, prng_key(0), device="cpu")
    cam = geometry.Camera.create(420.0, 418.0, 376.0, 240.0)
    with pytest.raises(TypeError, match="make_sharded_tracker"):
        tracker.tracker_step(state, torch.zeros(480, 752), 0.0, cam, torch.ones(5, 4),
                             torch.ones(5, dtype=torch.bool), TrackerConfig(n_particles=8),
                             pf_fn=lambda *a: None)
