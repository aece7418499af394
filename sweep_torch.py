#!/usr/bin/env python3
"""Parameter sweeps of the PyTorch + CUDA port: the test1/2/3.launch analogue.

The port's counterpart of `benchmarks/sweep.py`, with its grid files, JSON
keys, markdown matrix and rounding.  The reference reruns one bag with the
noise bounds, particle counts and tolerances varied; this script does the
same on the synthetic orbit: a grid file (configs/sweeps/*.yaml) declares
a base tracker config and axes, every cell of their cartesian product runs
end to end, and the results are one JSON artifact and a markdown matrix.

Grid schema:
    base:   {tracker-config overrides common to all cells}
    axes:   {field: [values, ...], ...}     # cartesian product
    run:    {frames: 40, fps: 50.0, seeds: 1}
An axis on `max_translation_noise` / `max_angular_noise` also sets the
matching `min_*` to the negated value (the reference's launch files sweep
them in pairs).  Grids are read with the port's YAML reader.

    python3 sweep_torch.py configs/sweeps/fault_grid.yaml --md out.md [--out out.json]
    python3 sweep_torch.py configs/sweeps/fault_grid.yaml --device cpu
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import time

import torch

from accuracy_torch import device_of, track
from pf_monocular_pose_estimator_tpu_torch.io.flat_yaml import load
from pf_monocular_pose_estimator_tpu_torch.io.metrics import (absolute_trajectory_error,
                                                              orientation_error_deg)
from pf_monocular_pose_estimator_tpu_torch.io.synthetic import (default_camera, demo_markers,
                                                                make_orbit_sequence)
from pf_monocular_pose_estimator_tpu_torch.tracker import TargetState, make_tracker
from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig
from pf_monocular_pose_estimator_tpu_torch.utils.prng import prng_key

ROOT = os.path.dirname(os.path.abspath(__file__))

_SYMMETRIC = {
    "max_translation_noise": "min_translation_noise",
    "max_angular_noise": "min_angular_noise",
}


def expand(grid: dict) -> list[tuple[dict, TrackerConfig]]:
    """Every cell of the grid's cartesian product over `axes`, in order:
    (the axes' values by name, the cell's TrackerConfig on top of `base`)."""
    axes = grid.get("axes", {})
    names = list(axes.keys())
    cells = []
    for values in itertools.product(*(axes[k] for k in names)):
        overrides = dict(grid.get("base", {}))
        for k, v in zip(names, values):
            overrides[k] = v
            if k in _SYMMETRIC:
                overrides[_SYMMETRIC[k]] = -v
        cells.append((dict(zip(names, values)), TrackerConfig(**overrides)))
    return cells


def run_cell(camera, markers, config: TrackerConfig, seq, seeds: int) -> dict:
    """One cell over `seeds` runs, each from a new state of `prng_key(seed)`
    -> `tracked` (the mean), `ate_mm` and `ori_deg` (a list when seeds > 1)."""
    device = seq.frames.device
    step = make_tracker(camera, markers, torch.ones(markers.shape[0], dtype=torch.bool), config,
                        device=device)
    gt = seq.poses.cpu().numpy()
    tracked, ates, oris = [], [], []
    for seed in range(seeds):
        state = TargetState.create(config.n_particles, prng_key(seed), device=device)
        _, upd, est, _ = track(step, state, seq)
        tracked.append(float(upd.mean()))
        ates.append(round(absolute_trajectory_error(est, gt, upd) * 1000, 2)
                    if upd.any() else None)
        oris.append(round(orientation_error_deg(est, gt, upd), 2) if upd.any() else None)
    return {
        "tracked": round(float(sum(tracked) / len(tracked)), 3),
        "ate_mm": ates if seeds > 1 else ates[0],
        "ori_deg": oris if seeds > 1 else oris[0],
    }


def card_name(device: torch.device) -> str:
    """`nvidia-smi`'s name and power limit of the first card (its torch name
    where `nvidia-smi` gives none), or `cpu`."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out.splitlines()[0].strip() if out else torch.cuda.get_device_name(device)


def markdown(grid_file: str, out: dict) -> str:
    names = list(out["axes"].keys())
    lines = [
        "# Sweep matrix — " + os.path.basename(grid_file),
        "",
        out["note"], "",
        "| " + " | ".join(names) + " | tracked | ATE (mm) | orientation (deg) |",
        "|" + "---|" * (len(names) + 3),
    ]
    for c in out["cells"]:
        lines.append("| " + " | ".join(str(c["params"][k]) for k in names)
                     + f" | {c['tracked']} | {c['ate_mm']} | {c['ori_deg']} |")
    return "\n".join(lines) + "\n"


def main(argv=None) -> dict:
    """Run every cell of the grid, printing one JSON line a cell; write
    `--out` / `--md` and return the report."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("grid", help="sweep grid YAML")
    ap.add_argument("--out", default=None, help="output JSON path")
    ap.add_argument("--md", default=None, help="output markdown path")
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu (the plain twins, for tests)")
    args = ap.parse_args(argv)

    grid = load(args.grid)
    device = device_of(args.device)
    camera = default_camera(device)
    markers = demo_markers(device)
    run = grid.get("run", {})
    seq = make_orbit_sequence(camera, markers, num_frames=int(run.get("frames", 40)),
                              fps=float(run.get("fps", 50.0)), device=device)
    seeds = int(run.get("seeds", 1))

    cells = []
    t_all = time.time()
    for params, config in expand(grid):
        t0 = time.time()
        res = run_cell(camera, markers, config, seq, seeds)
        cell = {"params": params, **res, "wall_s": round(time.time() - t0, 1)}
        cells.append(cell)
        print(json.dumps(cell), flush=True)

    out = {
        "note": (
            "Parameter-sweep matrix (the reference's test1/2/3.launch "
            "analogue): cartesian grid over the axes below, each cell a "
            f"full end-to-end run on the {seq.frames.shape[0]}-frame "
            f"synthetic orbit, {seeds} seed(s)/cell."
        ),
        "grid_file": os.path.relpath(args.grid, ROOT),
        "base": grid.get("base", {}),
        "axes": grid.get("axes", {}),
        "seeds": seeds,
        "device": card_name(device),
        "cells": cells,
        "wall_s_total": round(time.time() - t_all, 1),
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}")
    if args.md:
        with open(args.md, "w") as f:
            f.write(markdown(args.grid, out))
        print(f"wrote {args.md}")
    return out


if __name__ == "__main__":
    main()
