"""`bench_torch.py`, the port's benchmark, against `bench.py` and the JAX tracker.

Its flags give `bench.py`'s metric names and error, its JSON line carries
every `bench.py` key, and its frame loop (`run_sequence`) over the first 8
frames of the port's orbit at 2,000 particles holds to the JAX tracker
(`make_tracker` stepped frame by frame on the reference's orbit frames)
with tests/test_torch_tracker.py's bars: frame 0 (the init) within 0.1 mm,
later frames within 0.05 mm and 0.1 deg, flags and `pose_updated` equal.
The `--targets 2` and `--sharded` paths hold to the default path's poses
with the same bars: every frame ends in Gauss-Newton from the same bound
pairs, whichever particle seeded it.  `--no-cache`'s build directory is
covered here with a stub build, and on the card in
tests/test_torch_kernels_cuda.py.  tests/test_torch_config.py reads its
import lines: no jax, nothing of the JAX package, `bench.py` or
`chip_smoke.py`."""

import ast
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf_monocular_pose_estimator_tpu.io.synthetic import default_camera as ref_default_camera
from pf_monocular_pose_estimator_tpu.io.synthetic import demo_markers as ref_demo_markers
from pf_monocular_pose_estimator_tpu.io.synthetic import make_orbit_sequence as ref_orbit
from pf_monocular_pose_estimator_tpu.tracker import TargetState as RefState
from pf_monocular_pose_estimator_tpu.tracker import make_tracker as ref_make_tracker
from pf_monocular_pose_estimator_tpu.utils import TrackerConfig as RefConfig
from pf_monocular_pose_estimator_tpu_torch.io.metrics import (absolute_trajectory_error,
                                                              orientation_error_deg)
from pf_monocular_pose_estimator_tpu_torch.io.synthetic import (default_camera, demo_markers,
                                                                make_orbit_sequence)
from pf_monocular_pose_estimator_tpu_torch.utils import cuda_lib

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import bench_torch  # noqa: E402

torch.set_num_threads(2)

N = 2_000
FRAMES = 8
CPU_ARGS = ["--device", "cpu", "--particles", str(N), "--frames", str(FRAMES)]


def bench_py_keys() -> list:
    """The keys of the JSON line `bench.py` prints, read from its source."""
    for node in ast.walk(ast.parse((ROOT / "bench.py").read_text())):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "metric" for k in node.keys):
            return [k.value for k in node.keys]
    raise AssertionError("bench.py prints no dict with a 'metric' key")


@pytest.mark.parametrize("argv, metric", [
    ([], "tracking_fps_752x480_100k_particles"),
    (["--targets", "2"], "tracking_fps_752x480_100k_particles_2targets"),
    (["--sharded"], "tracking_fps_752x480_100k_particles_sharded_mesh"),
    (["--ess-tau", "0.0"], "tracking_fps_752x480_100k_particles_ess0.0"),
])
def test_label_is_bench_py_metric(argv, metric):
    args = bench_torch.parse_args(argv)
    assert bench_torch.label(args) == metric
    assert (args.particles, args.frames, args.runs, args.warmup, args.device) == (
        100_000, 480, 5, 1, "cuda")
    assert not args.no_cache


def test_sharded_with_targets_exits_with_bench_py_error(capsys):
    with pytest.raises(SystemExit) as exc:
        bench_torch.parse_args(["--sharded", "--targets", "2"])
    assert exc.value.code == 2
    assert ("error: --sharded and --targets are mutually exclusive (the multi-target mesh "
            "path is benchmarks/sharded_bench.py)") in capsys.readouterr().err


def test_cuda_without_a_card_raises(monkeypatch):
    """`--device cuda` (the default) never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        bench_torch.main(["--particles", "100", "--frames", "2", "--runs", "1"])


def test_main_prints_one_json_line_with_bench_py_keys(capsys):
    out = bench_torch.main(CPU_ARGS + ["--runs", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == json.loads(json.dumps(out))
    keys = bench_py_keys()
    assert len(keys) == 8
    assert set(keys) <= set(line), set(keys) - set(line)
    assert line["metric"] == "tracking_fps_752x480_2k_particles"
    assert line["unit"] == "frames/s" and line["device"] == "cpu"
    assert line["updated_frames_fraction"] == 1.0
    assert len(line["fps_runs"]) == 1 and line["value"] == round(line["fps_max"], 2)
    assert line["fps_min"] <= line["fps_median"] <= line["fps_max"]
    assert line["syncs_per_frame"] > 0 and line["ate_mm"] < 10 and line["orientation_deg"] < 1.5


def test_cached_build_into_a_given_directory(tmp_path):
    """`--no-cache`'s building block: `cached_build(..., directory)` builds
    into that directory, once, and leaves the default one alone."""
    src = tmp_path / "stub.cu"
    src.write_text("// stub")
    fresh = tmp_path / "fresh"
    calls = []

    def build(tmp, out):
        assert Path(tmp).parent == fresh
        calls.append(out)
        Path(out).write_bytes(b"stub")

    so = cuda_lib.cached_build("bench_stub", ("-O3",), [src], build, fresh)
    assert so.parent == fresh and so.read_bytes() == b"stub"
    assert cuda_lib.cached_build("bench_stub", ("-O3",), [src], build, fresh) == so
    assert len(calls) == 1
    assert sorted(p.name for p in fresh.iterdir()) == [so.name]
    assert not list(cuda_lib.build_dir().glob("libbench_stub_*"))


def _path_run(argv):
    """run_sequence over the first FRAMES frames of the port's orbit on the
    CPU, on the path `argv` chooses: (flags, updated, poses) as numpy, and
    the step."""
    args = bench_torch.parse_args(CPU_ARGS + argv)
    cam, markers = default_camera("cpu"), demo_markers("cpu")
    seq = make_orbit_sequence(cam, markers, num_frames=FRAMES, fps=50.0, device="cpu")
    make_step, state0 = bench_torch.make_path(args, cam, markers, bench_torch.make_config(args),
                                              torch.device("cpu"))
    runs = []
    for _ in range(2 if not argv else 1):
        step = make_step()
        _, flags, updated, poses = bench_torch.run_sequence(step, state0, seq.frames, seq.times)
        runs.append((flags.numpy(), updated.numpy(), poses.numpy()))
    return runs, step


@pytest.fixture(scope="module")
def default_path():
    return _path_run([])


@pytest.fixture(scope="module")
def jax_run():
    """The reference tracker over the reference's orbit frames, frame by frame."""
    cam, markers = ref_default_camera(), ref_demo_markers()
    seq = ref_orbit(cam, markers, num_frames=FRAMES, fps=50.0)
    config = RefConfig(n_particles=N, min_blob_area=8.0, pf_max_retries=8,
                       roi_particle_subsample=128)
    step = ref_make_tracker(cam, markers, jnp.ones((markers.shape[0],), bool), config)
    state = RefState.create(N, jax.random.PRNGKey(0))
    flags, updated, poses = [], [], []
    for i in range(FRAMES):
        state, res = step(state, seq.frames[i], seq.times[i])
        flags.append(int(res.fail_flag))
        updated.append(bool(res.pose_updated))
        poses.append(np.asarray(res.pose))
    return np.asarray(flags), np.asarray(updated), np.stack(poses)


def _within_tracker_bars(ref, got):
    d_t = np.linalg.norm(ref[:, :3, 3] - got[:, :3, 3], axis=-1)
    rel = np.einsum("tij,tkj->tik", ref[:, :3, :3], got[:, :3, :3])
    ang = np.degrees(np.arccos(np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1)))
    assert d_t[0] < 1e-4, f"frame 0 differs by {d_t[0] * 1e3:.4f} mm"
    assert d_t.max() < 5e-5, f"max {d_t.max() * 1e3:.4f} mm at frame {d_t.argmax()}"
    assert ang.max() < 0.1, f"max {ang.max():.3f} deg at frame {ang.argmax()}"


def test_run_sequence_against_jax(default_path, jax_run):
    (runs, step) = default_path
    flags, updated, poses = runs[0]
    ref_flags, ref_updated, ref_poses = jax_run
    assert updated.all()
    np.testing.assert_array_equal(flags, ref_flags)
    np.testing.assert_array_equal(updated, ref_updated)
    _within_tracker_bars(ref_poses, poses)
    assert step.frames == FRAMES and step.host.count > 0


def test_runs_repeat_from_the_same_state(default_path):
    """Each run starts from the same initial state with a new tracker."""
    (first, second), _ = default_path
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("argv", [["--targets", "2"], ["--sharded"]])
def test_other_paths_against_the_default_path(default_path, argv):
    (runs, step) = _path_run(argv)
    flags, updated, poses = runs[0]
    ref_flags, ref_updated, ref_poses = default_path[0][0]
    np.testing.assert_array_equal(flags, ref_flags)
    np.testing.assert_array_equal(updated, ref_updated)
    _within_tracker_bars(ref_poses, poses)
    if argv == ["--sharded"]:
        assert step.bank.__class__.__name__ == "ShardedBank"
    else:
        assert len(step.trackers) == 2


@pytest.mark.slow
def test_orbit_480_frames_against_jax():
    """The whole 480-frame orbit of `bench.py`, free-running at 5,000
    particles in both trackers (~5 min on the CPU): every frame updated by
    both, and the port's ATE and orientation error over the run equal to
    the reference's within 0.5 mm and 0.05 deg, its median frame within
    0.05 mm of the reference's.  Late frames may part by rounding drift
    (ROADMAP fault k), so no per-frame maximum is held."""
    n, frames = 5_000, 480
    cam, markers = ref_default_camera(), ref_demo_markers()
    seq = ref_orbit(cam, markers, num_frames=frames, fps=50.0)
    config = RefConfig(n_particles=n, min_blob_area=8.0, pf_max_retries=8,
                       roi_particle_subsample=128)
    step = ref_make_tracker(cam, markers, jnp.ones((markers.shape[0],), bool), config)
    state = RefState.create(n, jax.random.PRNGKey(0))
    ref_poses, ref_updated = [], []
    for i in range(frames):
        state, res = step(state, seq.frames[i], seq.times[i])
        ref_poses.append(np.asarray(res.pose))
        ref_updated.append(bool(res.pose_updated))
    ref_poses, ref_updated = np.stack(ref_poses), np.asarray(ref_updated)

    args = bench_torch.parse_args(["--device", "cpu", "--particles", str(n)])
    cam_t, markers_t = default_camera("cpu"), demo_markers("cpu")
    seq_t = make_orbit_sequence(cam_t, markers_t, num_frames=frames, fps=50.0, device="cpu")
    make_step, state0 = bench_torch.make_path(args, cam_t, markers_t,
                                              bench_torch.make_config(args), torch.device("cpu"))
    _, _, updated, poses = bench_torch.run_sequence(make_step(), state0, seq_t.frames,
                                                    seq_t.times)
    updated, poses, gt = updated.numpy(), poses.numpy(), seq_t.poses.numpy()

    assert ref_updated.all() and updated.all()
    errors = {name: (absolute_trajectory_error(p, gt) * 1e3, orientation_error_deg(p, gt))
              for name, p in (("reference", ref_poses), ("port", poses))}
    apart = np.linalg.norm(ref_poses[:, :3, 3] - poses[:, :3, 3], axis=-1) * 1e3
    print(f"ATE mm, orientation deg: {errors}; the port from the reference: median "
          f"{np.median(apart):.4f} mm, max {apart.max():.3f} mm at frame {apart.argmax()}")
    (ref_ate, ref_ori), (ate, ori) = errors["reference"], errors["port"]
    assert abs(ate - ref_ate) < 0.5 and abs(ori - ref_ori) < 0.05
    assert np.median(apart) < 0.05
