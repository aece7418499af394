"""`sweep_torch.py`, the port's parameter sweep, against `benchmarks/sweep.py`,
the JAX script, on the CPU.

Both committed grids parse with the port's YAML reader as with
`yaml.safe_load`; `expand` gives the JAX script's cells in its order with
the reference's `TrackerConfig` fields (the symmetric `min_*` bounds
included); `run_cell` on one small cell (300 particles, 4 frames, 2 seeds)
holds to the JAX `run_cell` on each side's orbit: `tracked` equal, ATE
within 0.05 mm, orientation within 0.05 deg; `main` writes the JAX
script's JSON keys and markdown matrix, one row a cell, and `--device
cuda` raises without a card.  tests/test_torch_config.py reads the
script's import lines."""

import ast
import dataclasses
import itertools
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from benchmarks.sweep import _SYMMETRIC as REF_SYMMETRIC
from benchmarks.sweep import run_cell as ref_run_cell
from pf_monocular_pose_estimator_tpu.io.synthetic import default_camera as ref_default_camera
from pf_monocular_pose_estimator_tpu.io.synthetic import demo_markers as ref_demo_markers
from pf_monocular_pose_estimator_tpu.io.synthetic import make_orbit_sequence as ref_orbit
from pf_monocular_pose_estimator_tpu.utils import TrackerConfig as RefConfig
from pf_monocular_pose_estimator_tpu_torch.io.flat_yaml import load
from pf_monocular_pose_estimator_tpu_torch.io.synthetic import (default_camera, demo_markers,
                                                                make_orbit_sequence)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import sweep_torch  # noqa: E402

torch.set_num_threads(2)

GRIDS = sorted((ROOT / "configs" / "sweeps").glob("*.yaml"))


def test_two_grids_committed():
    assert [g.name for g in GRIDS] == ["fault_grid.yaml", "reference_grid.yaml"]


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: g.name)
def test_grid_parses_as_safe_load(grid):
    with open(grid) as f:
        want = yaml.safe_load(f)
    got = load(grid)
    assert got == want
    assert [type(v) for v in got["base"].values()] == [type(v) for v in want["base"].values()]


def _reference_cells(grid: dict) -> list:
    """`benchmarks/sweep.py:120-130`'s loop, with the reference's TrackerConfig."""
    axes = grid.get("axes", {})
    names = list(axes.keys())
    cells = []
    for values in itertools.product(*(axes[k] for k in names)):
        overrides = dict(grid.get("base", {}))
        for k, v in zip(names, values):
            overrides[k] = v
            if k in REF_SYMMETRIC:
                overrides[REF_SYMMETRIC[k]] = -v
        cells.append((dict(zip(names, values)), RefConfig(**overrides)))
    return cells


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: g.name)
def test_expand_equals_the_jax_loop(grid):
    with open(grid) as f:
        want = _reference_cells(yaml.safe_load(f))
    got = sweep_torch.expand(load(grid))
    assert len(got) == len(want) == {"fault_grid.yaml": 8, "reference_grid.yaml": 18}[grid.name]
    for (params, cfg), (ref_params, ref_cfg) in zip(got, want):
        assert list(params.items()) == list(ref_params.items())
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
        if "max_translation_noise" in params:
            assert cfg.min_translation_noise == -params["max_translation_noise"]
    assert sweep_torch._SYMMETRIC == REF_SYMMETRIC


def test_run_cell_against_jax():
    """One cell of 300 particles with the symmetric noise axis, 4 frames,
    2 seeds, on each side's orbit."""
    grid = {"base": {"min_blob_area": 8.0, "pf_max_retries": 8},
            "axes": {"n_particles": [300], "max_translation_noise": [0.025]}}
    (_, cfg), = sweep_torch.expand(grid)
    (_, ref_cfg), = _reference_cells(grid)
    cam, markers = ref_default_camera(), ref_demo_markers()
    want = ref_run_cell(cam, markers, ref_cfg, ref_orbit(cam, markers, num_frames=4, fps=50.0), 2)
    cam_t, markers_t = default_camera("cpu"), demo_markers("cpu")
    seq_t = make_orbit_sequence(cam_t, markers_t, num_frames=4, fps=50.0, device="cpu")
    got = sweep_torch.run_cell(cam_t, markers_t, cfg, seq_t, 2)
    print(f"port {got}\nreference {want}")
    assert list(got) == list(want) == ["tracked", "ate_mm", "ori_deg"]
    assert got["tracked"] == want["tracked"] == 1.0
    assert len(got["ate_mm"]) == len(got["ori_deg"]) == 2
    np.testing.assert_allclose(got["ate_mm"], want["ate_mm"], rtol=0, atol=0.05)
    np.testing.assert_allclose(got["ori_deg"], want["ori_deg"], rtol=0, atol=0.05)


def _jax_out_keys() -> list:
    """The keys of the JSON `benchmarks/sweep.py` writes, read from its source."""
    for node in ast.walk(ast.parse((ROOT / "benchmarks" / "sweep.py").read_text())):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "note" for k in node.keys):
            return [k.value for k in node.keys]
    raise AssertionError("benchmarks/sweep.py writes no dict with a 'note' key")


def test_main_writes_the_jax_scripts_json_and_matrix(tmp_path, capsys):
    """fault_grid.yaml's axes cut to one particle count of 64, on 2 frames
    and 1 seed: one printed line a cell, the JAX script's JSON keys, and
    its markdown header with one row a cell."""
    grid = tmp_path / "fault_grid.yaml"
    grid.write_text("base:\n  min_blob_area: 8.0\n  pf_max_retries: 8\naxes:\n"
                    "  n_particles: [64]\n  number_of_occlusions: [0, 1]\n"
                    "  number_of_false_detections: [0]\nrun:\n  frames: 2\n  fps: 50.0\n"
                    "  seeds: 1\n")
    out_json, out_md = tmp_path / "out.json", tmp_path / "out.md"
    out = sweep_torch.main([str(grid), "--device", "cpu", "--out", str(out_json),
                            "--md", str(out_md)])
    printed = capsys.readouterr().out.splitlines()
    assert [json.loads(line) for line in printed[:2]] == out["cells"]
    assert printed[2:] == [f"wrote {out_json}", f"wrote {out_md}"]
    written = json.loads(out_json.read_text())
    assert list(written) == _jax_out_keys()
    assert written == json.loads(json.dumps(out))
    assert written["device"] == "cpu" and written["seeds"] == 1
    assert [c["params"] for c in written["cells"]] == [
        {"n_particles": 64, "number_of_occlusions": o, "number_of_false_detections": 0}
        for o in (0, 1)]
    for c in written["cells"]:
        assert list(c) == ["params", "tracked", "ate_mm", "ori_deg", "wall_s"]
        assert 0.0 <= c["tracked"] <= 1.0

    md = out_md.read_text().splitlines()
    tpu_md = (ROOT / "benchmarks" / "SWEEP_FAULTS_r05.md").read_text().splitlines()
    assert md[0] == tpu_md[0] == "# Sweep matrix — fault_grid.yaml"
    assert md[2] == ("Parameter-sweep matrix (the reference's test1/2/3.launch analogue): "
                     "cartesian grid over the axes below, each cell a full end-to-end run on "
                     "the 2-frame synthetic orbit, 1 seed(s)/cell.")
    assert md[4:6] == tpu_md[4:6]
    rows = md[6:]
    assert len(rows) == len(written["cells"]) == 2
    for row, c in zip(rows, written["cells"]):
        assert row == (f"| 64 | {c['params']['number_of_occlusions']} | 0 | {c['tracked']} | "
                       f"{c['ate_mm']} | {c['ori_deg']} |")


def test_cuda_without_a_card_raises(monkeypatch):
    """`--device cuda` (the default) never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    grid = str(ROOT / "configs" / "sweeps" / "fault_grid.yaml")
    with pytest.raises(RuntimeError, match="needs a GPU"):
        sweep_torch.main([grid])
