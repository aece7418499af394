"""The port's run_tracker CLI against the JAX package's, with the same argv on
the CPU: the summaries' keys, frame counts and fail flags equal, ATE within
0.05 mm and orientation error within 0.1 deg (tests/test_torch_tracker.py's
bars).  Each JAX run is a module-scoped fixture, so it compiles once."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from pf_monocular_pose_estimator_tpu.io.cli import main as ref_main
from pf_monocular_pose_estimator_tpu_torch.io import cli
from pf_monocular_pose_estimator_tpu_torch.utils import trace

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPERIMENTS = os.path.join(ROOT, "configs", "experiments")
CPU = ["--device", "cpu", "--json"]
# the fewest particles tried (16, 32, 64, ..., 1,000) at which both CLIs
# track every one of the two-UAV golden's first 8 frames
TWO_UAV_PARTICLES = "16"


def run(main, argv) -> dict:
    """main(argv) with its stdout captured; its last line, the summary."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def assert_summaries_agree(port: dict, ref: dict):
    assert port.keys() == ref.keys()
    for key in ("frames", "tracked_frames", "flags", "tracked_fraction_per_target"):
        assert port.get(key) == ref.get(key), key
    if "ate_m" in ref:
        assert abs(port["ate_m"] - ref["ate_m"]) < 5e-5
        assert abs(port["orientation_err_deg"] - ref["orientation_err_deg"]) < 0.1
    for got, want in zip(port.get("ate_m_per_target", []), ref.get("ate_m_per_target", [])):
        assert abs(got - want) < 5e-5


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("cli")


@pytest.fixture(scope="module")
def uav_target(tmp):
    argv = ["--config", os.path.join(EXPERIMENTS, "uav_target.yaml"), "--frames", "6",
            "--particles", "500", *CPU]
    return (run(cli.main, argv + ["--save-video", str(tmp / "port_video.npz")]),
            run(ref_main, argv + ["--save-video", str(tmp / "ref_video.npz")]))


@pytest.fixture(scope="module")
def recorded(tmp):
    argv = ["--synthetic", "--frames", "5", "--particles", "500", *CPU]
    return (run(cli.main, argv + ["--record", str(tmp / "port.pfsq")]),
            run(ref_main, argv + ["--record", str(tmp / "ref.pfsq")]))


@pytest.fixture(scope="module")
def replayed(tmp, recorded):
    argv = ["--sequence", str(tmp / "port.pfsq"), "--particles", "500", *CPU]
    return run(cli.main, argv), run(ref_main, argv)


@pytest.fixture(scope="module")
def two_uav(tmp):
    d = np.load(os.path.join(ROOT, "tests", "golden", "two_uav_sequence.npz"))
    path = str(tmp / "two_uav_8.npz")
    np.savez(path, frames=d["frames"][:8], times=d["times"][:8], poses=d["poses"][:8])
    argv = ["--config", os.path.join(EXPERIMENTS, "two_uav_bag.yaml"), "--sequence", path,
            "--particles", TWO_UAV_PARTICLES, *CPU]
    return run(cli.main, argv), run(ref_main, argv)


@pytest.fixture(scope="module")
def outdoor_expo():
    argv = ["--config", os.path.join(EXPERIMENTS, "outdoor_expo.yaml"), "--frames", "5",
            "--particles", "500", *CPU]
    return run(cli.main, argv), run(ref_main, argv)


def test_uav_target_equals_the_reference(uav_target, tmp):
    port, ref = uav_target
    assert_summaries_agree(port, ref)
    assert port["frames"] == 6 and port["tracked_frames"] == 6
    for name in ("port_video.npz", "ref_video.npz"):
        video = np.load(tmp / name)["frames"]
        assert video.shape == (6, 480, 752, 3) and video.dtype == np.uint8


def test_synthetic_recordings_are_the_same_bytes(recorded, tmp):
    port, ref = recorded
    assert_summaries_agree(port, ref)
    blob = (tmp / "port.pfsq").read_bytes()
    assert len(blob) == 64 + 5 * (8 + 480 * 752)
    assert blob == (tmp / "ref.pfsq").read_bytes()


def test_pfsq_replay_equals_the_reference(replayed, recorded):
    port, ref = replayed
    assert_summaries_agree(port, ref)
    assert port["frames"] == 5 and "ate_m" not in port
    assert port["tracked_frames"] >= recorded[0]["tracked_frames"] - 1


def test_two_uav_split_markers_equal_the_reference(two_uav):
    port, ref = two_uav
    assert_summaries_agree(port, ref)
    assert port["tracked_frames"] == 8
    assert port["tracked_fraction_per_target"] == [1.0, 1.0]
    assert all(len(f) == 2 for f in port["flags"]) and len(port["ate_m_per_target"]) == 2


def test_outdoor_expo_exposure_equals_the_reference(outdoor_expo):
    port, ref = outdoor_expo
    assert_summaries_agree(port, ref)
    assert port["exposure_us"] == ref["exposure_us"]


def test_parser_takes_the_reference_flags():
    from pf_monocular_pose_estimator_tpu.io.cli import build_parser as ref_parser

    def flags(parser):
        return {a.dest: a.default for a in parser._actions if a.dest != "help"}

    got, want = flags(cli.build_parser()), flags(ref_parser())
    assert set(want) - set(got) == {"no_cache"} and set(got) <= set(want)
    assert {k: v for k, v in got.items() if k != "device"} == \
        {k: v for k, v in want.items() if k not in ("device", "no_cache")}
    assert got["device"] == "cuda"
    with contextlib.redirect_stderr(io.StringIO()), pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--device", "tpu"])


@pytest.mark.parametrize("argv, want", [
    # the flag beats the file
    (["--config", "uav_target.yaml", "--frames", "6", "--particles", "500", "--seed", "3"],
     dict(frames=6, seed=3, n_particles=500, synthetic=True)),
    # the file beats the default
    (["--config", "uav_target.yaml"], dict(frames=60, seed=0, n_particles=20000, synthetic=True)),
    (["--config", "ipe_legacy.yaml", "--pf-retries", "3"],
     dict(frames=40, n_particles=64, pf_max_retries=3, use_particle_filter=False)),
    # the default where neither sets it
    (["--synthetic"], dict(frames=60, fps=50.0, seed=0, num_targets=1)),
])
def test_precedence_flag_then_file_then_default(argv, want):
    argv = [os.path.join(EXPERIMENTS, a) if a.endswith(".yaml") else a for a in argv]
    args, overrides = cli.resolve(argv)
    for key, value in want.items():
        got = overrides.get(key) if key in ("n_particles", "pf_max_retries",
                                             "use_particle_filter") else getattr(args, key)
        assert got == value and type(got) is type(value), key
    if argv == ["--synthetic"]:
        assert overrides == {}


@pytest.mark.parametrize("argv, n", [
    (["--synthetic", "--frames", "1", "--particles", "32"], 32),
    (["--config", os.path.join(EXPERIMENTS, "ipe_legacy.yaml"), "--frames", "1"], 64),
    (["--synthetic", "--frames", "1"], 1000),
])
def test_checkpoint_holds_the_resolved_particle_count(tmp_path, argv, n):
    path = str(tmp_path / "state.npz")
    summary = run(cli.main, argv + ["--checkpoint", path, *CPU])
    assert summary["checkpoint"] == path and summary["frames"] == 1
    assert np.load(path)["leaf_bank"].shape == (16, n)


def test_replicated_targets_and_profile(tmp_path):
    """two_targets.yaml replicates one marker set over two targets; --profile
    writes a torch.profiler trace, with the frame step's spans, and leaves
    tracing off."""
    summary = run(cli.main, ["--config", os.path.join(EXPERIMENTS, "two_targets.yaml"),
                             "--frames", "2", "--particles", "64", "--profile",
                             str(tmp_path / "trace"), *CPU])
    assert summary["tracked_fraction_per_target"] == [1.0, 1.0]
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    assert {"multi.frame", "tracker.frame", "detect"} <= {e.get("name") for e in events}
    assert trace.span("detect") is trace.span("refine") and trace.take() == []


def test_cli_runs_on_the_card_unless_told_otherwise(tmp_path):
    argv = ["--synthetic", "--frames", "1", "--particles", "16", "--json", "--checkpoint",
            str(tmp_path / "state.npz")]
    if torch.cuda.is_available():
        assert run(cli.main, argv)["frames"] == 1
    else:
        with contextlib.redirect_stdout(io.StringIO()), \
                pytest.raises((AssertionError, RuntimeError)):
            cli.main(argv)


def test_console_scripts_name_the_port():
    """pyproject's port entries resolve to the CLI and the multi-host launcher,
    each returning exit code 0, and the `torch` extra needs no yaml."""
    import importlib
    import tomllib

    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        project = tomllib.load(f)["project"]
    scripts = project["scripts"]
    assert "pyyaml" not in project["optional-dependencies"]["torch"]
    targets = {}
    for name in ("pfmpe-track-torch", "pfmpe-multihost-torch"):
        module, attr = scripts[name].split(":")
        targets[name] = getattr(importlib.import_module(module), attr)
    assert targets["pfmpe-track-torch"] is cli.main
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = targets["pfmpe-multihost-torch"](["--frames", "1", "--particles", "256",
                                                "--device", "cpu"])
    assert rc == 0 and json.loads(out.getvalue().splitlines()[-1])["frames"] == 1
