"""The port's io/ modules against the JAX package's on the same inputs: the
YAML reader against `yaml.safe_load`, the experiment / marker / camera
loaders, PFSQ containers written by one package and read by the other, the
frame pipes, and `render_overlay` pixel for pixel."""

import glob
import math
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pf_monocular_pose_estimator_tpu.io import experiment as ref_experiment
from pf_monocular_pose_estimator_tpu.io import markers as ref_markers
from pf_monocular_pose_estimator_tpu.io import seqio as ref_seqio
from pf_monocular_pose_estimator_tpu.io import synthetic as ref_synthetic
from pf_monocular_pose_estimator_tpu.io.viz import render_overlay as ref_render_overlay
from pf_monocular_pose_estimator_tpu_torch.io import flat_yaml, framepipe, seqio
from pf_monocular_pose_estimator_tpu_torch.io.experiment import load_experiment
from pf_monocular_pose_estimator_tpu_torch.io.markers import (load_camera_calibration,
                                                              load_marker_positions)
from pf_monocular_pose_estimator_tpu_torch.io.synthetic import default_camera
from pf_monocular_pose_estimator_tpu_torch.io.viz import _COLORS, render_overlay
from pf_monocular_pose_estimator_tpu_torch.tracker import FrameResult
from pf_monocular_pose_estimator_tpu_torch.utils import native_lib
from pf_monocular_pose_estimator_tpu_torch.utils.cuda_lib import build_dir

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))
EXPERIMENTS = sorted(glob.glob(os.path.join(ROOT, "configs", "experiments", "*.yaml")))
HAVE_CXX = native_lib.compiler() is not None
NATIVE = [False] + ([True] if HAVE_CXX else [])


def same(a, b) -> bool:
    """Equal values of equal types, recursively (1 != 1.0 != True here)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


# ---------------------------------------------------------------- YAML reader

def test_configs_cover_the_subset():
    assert len(CONFIGS) >= 12 and len(EXPERIMENTS) >= 7


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, ROOT))
def test_reader_equals_safe_load_on_every_config(path):
    with open(path) as f:
        want = yaml.safe_load(f)
    assert same(flat_yaml.load(path), want)


SNIPPETS = [
    "a: 20000", "a: 8.0", "a: 2000.0", "a: true", "a: 1e-3", "a: 1.0e3", "a: 1.0e+3",
    "a: 1.5e-7", "a: -.5", "a: .5", "a: 1.", "a: 09", "a: 1_000", "a: +5", "a: -0", "a: 0",
    "a: yes", "a: Off", "a: ~", "a: null", "a:", "a: x 'y # z'",
    "a: .inf", "a: -.inf", "a: .NaN", "a: [1, 2,]", "a: []", "a: [-0.36, 0.13, 0.0005]",
    "a: [true, 1, x, 2.5]", "a: x, y", "a: a#b", "a: it's", "a: 1 # c", "# only a comment", "", "a:\n- 1\n- 2", "- 1\n- 2",
    "x:\n  - a: 1\n    b: [1, 2]\n  - c: d\n", "-\n  a: 1", "k:\n  v", "on: off",
    "outer:\n  inner:\n    deep: 3\n  back: 4\nlast: 5", "a: b c d",
]


@pytest.mark.parametrize("text", SNIPPETS)
def test_reader_equals_safe_load_on_snippets(text):
    assert same(flat_yaml.loads(text), yaml.safe_load(text))


OUTSIDE = [
    "a: &x 1", "a: *x", "a: !!int 1", "a: {b: 1}", "a: |\n  x", "a: >\n  x", "a:\n\tb: 1",
    'a: "x\\n"', "a: 'it''s'", "a: x\n  y", "a: 1:20", "a: 2001-12-14", "<<: 1", "? a\n: b",
    "---\na: 1", "%YAML 1.1\na: 1", "a: [[1]]", "a: [1,\n 2]", "a: 1\na: 2", "- - 1",
    "a: b: c", "a: 'open", "a: 'x # y'", 'a: "q"  # c', "'a': 1", "a: ['x']", "a: 012",
    "a: 0x1F", "a: -0x1f", "a: 0b101",
]


@pytest.mark.parametrize("text", OUTSIDE)
def test_reader_raises_outside_the_subset(text):
    with pytest.raises(ValueError, match=r"f\.yaml:\d+"):
        flat_yaml.loads(text, "f.yaml")


# ---------------------------------------------------------------- loaders

@pytest.mark.parametrize("path", EXPERIMENTS, ids=os.path.basename)
def test_load_experiment_equals_the_reference(path):
    got, want = load_experiment(path), ref_experiment.load_experiment(path)
    assert same(got, want), (got, want)


def test_load_experiment_rejects_unknown_fields_and_makes_tuples(tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("tracker:\n  not_a_field: 3\n")
    with pytest.raises(ValueError, match="not_a_field"):
        load_experiment(str(bad))
    ok = tmp_path / "ok.yaml"
    ok.write_text("tracker:\n  marker_downgrade: [true, false, false, false, false]\n"
                  "run:\n  sequence: seq.npz\n")
    got, want = load_experiment(str(ok)), ref_experiment.load_experiment(str(ok))
    assert same(got, want) and got["tracker"]["marker_downgrade"] == (True,) + (False,) * 4
    assert got["run"]["sequence"] == str(tmp_path / "seq.npz")


@pytest.mark.parametrize("split", [None, [5, 5], [4, 6]])
@pytest.mark.parametrize("name", ["demo_marker_positions.yaml", "two_uav_marker_positions.yaml"])
def test_load_marker_positions_equals_the_reference(name, split):
    path = os.path.join(ROOT, "configs", name)
    if name.startswith("demo") and split is not None:
        split = [2, 3]
    got, want = load_marker_positions(path, split), ref_markers.load_marker_positions(path, split)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape[1] == 4
        np.testing.assert_array_equal(g, w)


def test_load_marker_positions_bad_split_raises():
    path = os.path.join(ROOT, "configs", "two_uav_marker_positions.yaml")
    with pytest.raises(ValueError, match="sums to 9"):
        ref_markers.load_marker_positions(path, [5, 4])
    with pytest.raises(ValueError, match="sums to 9"):
        load_marker_positions(path, [5, 4])


def _cameras_equal(cam, ref):
    for name in ("fx", "fy", "cx", "cy", "dist"):
        np.testing.assert_array_equal(getattr(cam, name).numpy(), np.asarray(getattr(ref, name)))
    assert (cam.width, cam.height) == (ref.width, ref.height)


@pytest.mark.parametrize("path", EXPERIMENTS, ids=os.path.basename)
def test_load_camera_calibration_equals_the_reference(path):
    camera = load_experiment(path)["camera"]
    got = load_camera_calibration(camera, device="cpu")
    assert got.fx.device.type == "cpu"
    _cameras_equal(got, ref_markers.load_camera_calibration(camera))


def test_load_camera_calibration_defaults(tmp_path):
    path = tmp_path / "cam.yaml"
    path.write_text("fx: 400.5\nfy: 401\ncx: 376.0\ncy: 240.0\n")
    _cameras_equal(load_camera_calibration(str(path), device="cpu"),
                   ref_markers.load_camera_calibration(str(path)))


def test_load_camera_calibration_defaults_to_the_card():
    path = os.path.join(ROOT, "configs", "camera_mvbluefox.yaml")
    if torch.cuda.is_available():
        assert load_camera_calibration(path).fx.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            load_camera_calibration(path)


# ---------------------------------------------------------------- PFSQ

def _demo(t=7, h=24, w=32, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (t, h, w), dtype=np.uint8), np.arange(t) / 50.0 + 0.25


PACKAGES = {"port": seqio, "jax": ref_seqio}


@pytest.mark.parametrize("r_native", NATIVE)
@pytest.mark.parametrize("r_pkg", ["port", "jax"])
@pytest.mark.parametrize("w_native", NATIVE)
@pytest.mark.parametrize("w_pkg", ["port", "jax"])
def test_pfsq_written_by_one_package_reads_in_the_other(tmp_path, w_pkg, w_native, r_pkg,
                                                        r_native):
    frames, times = _demo(seed=3)
    path = str(tmp_path / "seq.pfsq")
    assert PACKAGES[w_pkg].record_sequence(path, frames, times, native=w_native) == 7
    with PACKAGES[r_pkg].SequenceReader(path, native=r_native) as r:
        assert (r.n_frames, r.height, r.width) == frames.shape
        got, ts = r.arrays()
    np.testing.assert_array_equal(got, frames)
    np.testing.assert_array_equal(ts, times)


def test_pfsq_files_are_byte_identical(tmp_path):
    frames, times = _demo(seed=5)
    blobs = []
    for pkg in ("port", "jax"):
        for native in NATIVE:
            path = tmp_path / f"{pkg}_{native}.pfsq"
            PACKAGES[pkg].record_sequence(str(path), frames, times, native=native)
            blobs.append(path.read_bytes())
    assert len(blobs[0]) == 64 + 7 * (8 + 24 * 32)
    assert all(b == blobs[0] for b in blobs)


@pytest.mark.parametrize("native", NATIVE)
def test_pfsq_truncated_file_clamps(tmp_path, native):
    frames, times = _demo()
    path = str(tmp_path / "seq.pfsq")
    seqio.record_sequence(path, frames, times, native=native)
    full = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(full - (8 + frames.shape[1] * frames.shape[2]) - 1)  # the last frame cut
    with seqio.SequenceReader(path, native=native) as r:
        assert r.n_frames == frames.shape[0] - 2
        got, _ = r.arrays()
    np.testing.assert_array_equal(got, frames[: r.n_frames])


@pytest.mark.parametrize("native", NATIVE)
def test_pfsq_zero_copy_view(tmp_path, native):
    frames, times = _demo()
    path = str(tmp_path / "seq.pfsq")
    seqio.record_sequence(path, frames, times, native=native)
    with seqio.SequenceReader(path, native=native) as r:
        assert r.native == native
        px, t = r.frame(3)
        assert px.base is not None and not px.flags.owndata  # a view of the mapping
        np.testing.assert_array_equal(px, frames[3])
        assert t == times[3]
        with pytest.raises(IndexError):
            r.frame(7)


def test_native_is_chosen_by_the_compiler(monkeypatch, tmp_path):
    """native=None takes the C++ library when a compiler is present, numpy
    when none is; native=False is numpy either way."""
    frames, times = _demo()
    path = str(tmp_path / "seq.pfsq")
    with seqio.SequenceWriter(path, 24, 32, native=False) as w:
        assert not w.native
    monkeypatch.setattr(native_lib, "compiler", lambda: None)
    seqio.record_sequence(path, frames, times)
    with seqio.SequenceReader(path) as r:
        assert not r.native
    if HAVE_CXX:
        monkeypatch.undo()
        with seqio.SequenceReader(path) as r:
            assert r.native


@pytest.mark.skipif(not HAVE_CXX, reason="no C++ compiler")
def test_native_build_failure_raises_with_the_compiler_message(tmp_path):
    broken = tmp_path / "broken_source.cpp"
    broken.write_text('extern "C" int f() { return undeclared_name_in_broken_source; }\n')
    with pytest.raises(RuntimeError, match="undeclared_name_in_broken_source"):
        native_lib.build(broken)
    assert not list(build_dir().glob("libbroken_source*"))


@pytest.mark.skipif(not HAVE_CXX, reason="no C++ compiler")
def test_native_build_lands_in_the_build_directory():
    so = native_lib.build(native_lib.NATIVE / "seqio.cpp")
    assert so.parent.name == "torch_kernels" and so.name.startswith("libseqio_")
    assert so.parent.parent.name == "build"


# ---------------------------------------------------------------- frame pipe

PIPES = [framepipe.PyFramePipe] + ([framepipe.FramePipe] if HAVE_CXX else [])


@pytest.mark.parametrize("cls", PIPES)
def test_pipe_push_pop_grayscale_roundtrip(cls):
    pipe = cls(64, 48, capacity=4)
    frame = np.random.default_rng(0).integers(0, 255, (48, 64), np.uint8)
    seq = pipe.push(frame, 1.25)
    got, ts, oseq = pipe.pop(timeout_ms=500)
    np.testing.assert_array_equal(got, frame)
    assert ts == 1.25 and oseq == seq == 0


@pytest.mark.parametrize("cls", PIPES)
def test_pipe_red_channel_extraction(cls):
    pipe = cls(64, 48, capacity=4)
    bgr = np.zeros((48, 64, 3), np.uint8)
    bgr[..., 0], bgr[..., 1], bgr[..., 2] = 10, 20, 99
    pipe.push(bgr, 2.0)
    got, _, _ = pipe.pop(timeout_ms=500)
    assert (got == 99).all()


@pytest.mark.parametrize("cls", PIPES)
def test_pipe_pop_timeout(cls):
    pipe = cls(8, 8, capacity=4)
    t0 = time.monotonic()
    assert pipe.pop(timeout_ms=80) is None
    assert time.monotonic() - t0 >= 0.07


@pytest.mark.parametrize("cls", PIPES)
def test_pipe_drop_oldest_when_full(cls):
    p = cls(8, 8, capacity=3)
    for i in range(6):
        p.push(np.full((8, 8), i, np.uint8), float(i))
    assert p.stats == {"pushed": 6, "dropped": 3, "pending": 3}
    vals = []
    while (out := p.pop(timeout_ms=10)) is not None:
        vals.append((int(out[0][0, 0]), out[2]))
    assert vals == [(3, 3), (4, 4), (5, 5)]


@pytest.mark.parametrize("cls", PIPES)
def test_pipe_pop_latest_skips_stale(cls):
    p = cls(8, 8, capacity=8)
    for i in range(5):
        p.push(np.full((8, 8), i, np.uint8), float(i))
    got, ts, seq, skipped = p.pop_latest(timeout_ms=100)
    assert (int(got[0, 0]), ts, seq, skipped) == (4, 4.0, 4, 4)
    assert p.stats["pending"] == 0
    assert p.pop_latest(timeout_ms=10) is None


@pytest.mark.parametrize("cls", PIPES)
def test_pipe_replay_thread(cls):
    frames = np.stack([np.full((8, 8), i, np.uint8) for i in range(10)])
    p = cls(8, 8, capacity=16)
    p.start_replay(frames, fps=200.0, t0=5.0)
    got = []
    for _ in range(10):
        out = p.pop(timeout_ms=1000)
        assert out is not None
        got.append((int(out[0][0, 0]), out[1], out[2]))
    p.stop_replay()
    assert [g[0] for g in got] == list(range(10)) == [g[2] for g in got]
    np.testing.assert_allclose([g[1] for g in got], 5.0 + np.arange(10) / 200.0)
    assert p.stats == {"pushed": 10, "dropped": 0, "pending": 0}


@pytest.mark.parametrize("cls", PIPES)
def test_pipe_close_wakes_the_consumer_and_refuses_pushes(cls):
    p = cls(8, 8, capacity=4)
    p.push(np.zeros((8, 8), np.uint8), 0.0)
    p.close()
    assert p.pop(timeout_ms=10) is not None  # drained after the close ...
    t0 = time.monotonic()
    assert p.pop(timeout_ms=2000) is None  # ... then no wait
    assert time.monotonic() - t0 < 1.0
    with pytest.raises(RuntimeError):
        p.push(np.zeros((8, 8), np.uint8), 1.0)


# ---------------------------------------------------------------- overlays

def _rotation(rng, scale):
    w = rng.normal(size=3) * scale
    th = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / max(th, 1e-12)
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


def _overlay_inputs(seed, updated=True, faults=False, n_particles=200):
    """Result values as a tracker gives them (float32 / bool), the frame,
    particles about the pose and non-uniform weights."""
    rng = np.random.default_rng(seed)
    pose = np.eye(4)
    pose[:3, :3] = _rotation(rng, 0.3)
    pose[:3, 3] = [rng.uniform(-0.2, 0.2), rng.uniform(-0.1, 0.1), rng.uniform(1.0, 2.0)]
    k = 16
    mask = rng.random(k) < 0.6
    occluded = faults & (rng.random(k) < 0.25)
    injected = faults & mask & (rng.random(k) < 0.4)
    if faults:  # at least one of each
        occluded[0], mask[1], injected[1] = True, True, True
    values = dict(
        pose=pose.astype(np.float32),
        pose_updated=np.asarray(updated),
        detections_xy=rng.uniform([10, 10], [742, 470], (k, 2)).astype(np.float32),
        detections_mask=mask,
        detections_occluded=occluded,
        detections_injected=injected,
        roi=np.array([rng.uniform(0, 300), rng.uniform(0, 200), rng.uniform(100, 400),
                      rng.uniform(80, 250)], np.float32),
    )
    particles = np.repeat(pose[None], n_particles, 0)
    for p in particles:
        p[:3, :3] = p[:3, :3] @ _rotation(rng, 0.1)
        p[:3, 3] += rng.normal(size=3) * 0.02
    weights = rng.gamma(0.5, size=n_particles).astype(np.float32)
    frame = (rng.random((480, 752)) * 255.0).astype(np.float32)
    return values, frame, particles.astype(np.float32), weights


def _port_result(values) -> FrameResult:
    fields = {f: torch.zeros(()) for f in FrameResult.__dataclass_fields__}
    fields.update({k: torch.from_numpy(np.asarray(v)) for k, v in values.items()})
    return FrameResult(**fields)


def _both(values, frame, particles=None, weights=None):
    class Ref:
        pass

    ref = Ref()
    for k, v in values.items():
        setattr(ref, k, jnp.asarray(v))
    want = ref_render_overlay(jnp.asarray(frame), ref_synthetic.default_camera(), ref,
                              particles, weights)
    got = render_overlay(torch.from_numpy(frame), default_camera("cpu"), _port_result(values),
                         None if particles is None else torch.from_numpy(particles),
                         None if weights is None else torch.from_numpy(weights))
    assert got.dtype == np.uint8 and got.shape == (480, 752, 3)
    np.testing.assert_array_equal(got, want)
    return got


def _has(img, color):
    return bool(np.any(np.all(img == np.asarray(color, np.uint8), axis=-1)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_overlay_fault_colour_codes_equal_the_reference(seed):
    values, frame, _, _ = _overlay_inputs(seed, faults=True)
    img = _both(values, frame)
    assert values["detections_occluded"].any() and values["detections_injected"].any()
    assert _has(img, _COLORS["occluded"]) and _has(img, _COLORS["injected"])


@pytest.mark.parametrize("seed", [3, 4])
def test_overlay_true_detections_and_axes_equal_the_reference(seed):
    values, frame, _, _ = _overlay_inputs(seed)
    img = _both(values, frame)
    for name in ("detection", "roi", "axis_x", "axis_y", "axis_z"):
        assert _has(img, _COLORS[name]), name
    assert not np.all(img[:6] == np.asarray((255, 0, 0), np.uint8))


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_overlay_particle_trivectors_equal_the_reference(seed):
    values, frame, particles, weights = _overlay_inputs(seed)
    img = _both(values, frame, particles, weights)
    assert _has(img, _COLORS["particle"])
    # weights decide the lengths: uniform ones draw another picture
    uniform = render_overlay(torch.from_numpy(frame), default_camera("cpu"),
                             _port_result(values), torch.from_numpy(particles),
                             torch.ones(len(weights)))
    assert not np.array_equal(img, uniform)


def test_overlay_lost_track_banner_equals_the_reference():
    values, frame, particles, weights = _overlay_inputs(8, updated=False)
    img = _both(values, frame, particles, weights)
    assert np.all(img[:6] == np.asarray((255, 0, 0), np.uint8))
    assert not _has(img, _COLORS["particle"])
