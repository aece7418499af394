"""Experiment config files, the launch-file tier (port of `io/experiment.py`).

One YAML file wires a camera calibration, a marker file (with the
numberOfMarkersUAVk split), tracker overrides and a data source into one
run of the CLI's `--config`:

    camera: camera_mvbluefox.yaml        # path, relative to this file
    markers: demo_marker_positions.yaml
    markers_per_object: [5]
    num_targets: 1
    tracker:                             # TrackerConfig field overrides
      n_particles: 20000
    run:                                 # data source and replay options
      synthetic: true                    # or  sequence: frames.npz
      frames: 60
      fps: 50.0
      seed: 0

Explicit CLI flags override the file; the file overrides built-in
defaults.  The file is read with the port's own reader (`io/flat_yaml.py`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict

from ..utils.config import TrackerConfig
from . import flat_yaml

_VALID_TRACKER_FIELDS = {f.name for f in dataclasses.fields(TrackerConfig)}


def load_experiment(path: str) -> Dict[str, Any]:
    """Parse an experiment YAML; resolves camera/markers/sequence paths
    relative to the file and validates tracker override names."""
    raw = flat_yaml.load(path) or {}
    base = os.path.dirname(os.path.abspath(path))

    def resolve(p):
        if p is None:
            return None
        return p if os.path.isabs(p) else os.path.join(base, p)

    tracker = dict(raw.get("tracker") or {})
    unknown = set(tracker) - _VALID_TRACKER_FIELDS
    if unknown:
        raise ValueError(f"{path}: unknown TrackerConfig fields {sorted(unknown)}")
    # YAML lists -> the tuple-typed fields
    for key, value in tracker.items():
        if isinstance(value, list):
            tracker[key] = tuple(value)

    run = dict(raw.get("run") or {})
    run["sequence"] = resolve(run.get("sequence"))

    return {
        "camera": resolve(raw.get("camera")),
        "markers": resolve(raw.get("markers")),
        "markers_per_object": raw.get("markers_per_object"),
        "num_targets": raw.get("num_targets"),
        "tracker": tracker,
        "run": run,
    }
