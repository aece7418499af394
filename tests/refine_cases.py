"""Problems for the fused refine (`pf/refine_kernel.py::refine_frame`): the
inputs the track branch hands its refine layer, built from a seed, for the
CPU tests (the plain twin against `tracker/step.py::refine_hypotheses`) and
the card tests (the kernel against the plain twin).  Imports no jax.

A problem is M markers 1.4 m in front of the camera, the picked particle's
pose `pre_gn` ~0.01 rad and ~1 cm off the truth, and K detection slots: each
marker's projection with 0.3 px of noise, a clutter detection 3 px from one
of them (the swap hypotheses bind it), far clutter beyond tol_pf, masked
slots holding garbage, and, at M >= 2, the last marker padded out.  A case
changes one thing:
  clean             as above
  tie               a detection slot copied onto another: equal distances, so
                    the greedy's first-minimum order decides
  occluded          two markers without a detection: the greedy's `done`
                    trips part-way
  infeasible        a residual gate no hypothesis meets: the result falls
                    back to pre_gn
  jump              a jump threshold the refined rotation exceeds
  guard_trusted     jump_translation_radius 5 mm and a prediction 5 cm off,
  guard_untrusted   trusted or not
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pf_monocular_pose_estimator_tpu_torch.geometry import Camera, exp_se3, project
from pf_monocular_pose_estimator_tpu_torch.ops.blob import Detections
from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig
from pf_monocular_pose_estimator_tpu_torch.utils.dynamic import DynamicParams

CAM = dict(fx=420.0, fy=418.0, cx=376.0, cy=240.0)
CASES = ("clean", "tie", "occluded", "infeasible", "jump", "guard_trusted", "guard_untrusted")


def frame_case(case: str, m: int, k: int, seed: int = 0, hypotheses: int = 4, device="cpu"):
    """-> dict of the refine layer's inputs (see `fused_args` and
    `chain_args`)."""
    assert case in CASES, case
    rng = np.random.default_rng(1000 * m + 10 * k + seed)
    cam = Camera.create(**CAM)
    gt = exp_se3(torch.tensor([0.02, -0.01, 0.0, 0.1, 0.2, 0.0]))
    gt[2, 3] += 1.4
    xyz = rng.normal(0.0, 0.08, (m, 3)).astype(np.float32)
    markers = torch.from_numpy(np.concatenate([xyz, np.ones((m, 1), np.float32)], 1))
    marker_mask = torch.ones(m, dtype=torch.bool)
    if m >= 2:
        marker_mask[-1] = False
    uv = project(cam, gt, markers)  # (M, 2)
    seen = list(rng.permutation(m))
    if case == "occluded":
        seen = seen[2:] if m > 2 else seen[1:]
    rows = [uv[i] + torch.from_numpy(rng.normal(0.0, 0.3, 2).astype(np.float32)) for i in seen]
    if rows:
        rows.append(rows[0] + torch.tensor([3.0, -1.0]))  # within tol_pf of one detection
    rows.append(uv.mean(0) + torch.tensor([60.0, 45.0]))  # beyond tol_pf of every marker
    if case == "tie" and rows:
        rows.insert(int(rng.integers(0, len(rows) + 1)), rows[0].clone())
    xy = torch.from_numpy(rng.uniform(0.0, 700.0, (k, 2)).astype(np.float32))
    mask = torch.zeros(k, dtype=torch.bool)
    slots = rng.permutation(k)[:min(k, len(rows))]
    for s, r in zip(slots, rows):
        xy[s], mask[s] = r, True
    det = Detections(xy=xy, xy_distorted=xy.clone(), mask=mask, area=torch.zeros(k),
                     occluded=torch.zeros(k, dtype=torch.bool),
                     injected=torch.zeros(k, dtype=torch.bool))
    pre_gn = exp_se3(torch.from_numpy(rng.normal(0.0, 0.01, 6).astype(np.float32))) @ gt
    config = TrackerConfig(gn_hypotheses=hypotheses)
    predicted, trust = gt.clone(), torch.tensor(True)
    if case == "infeasible":
        config = dataclasses.replace(config, gn_residual_gate=-1.0)
    if case.startswith("guard"):
        config = dataclasses.replace(config, jump_translation_radius=0.005)
        predicted[0, 3] += 0.05
        trust = torch.tensor(case == "guard_trusted")
    dyn = DynamicParams.from_config(config)
    if case == "jump":
        dyn = dataclasses.replace(dyn, jump_threshold=torch.tensor(1e-4))
    dev = torch.device(device)
    det = Detections(**{f.name: getattr(det, f.name).to(dev) for f in dataclasses.fields(det)})
    dyn = DynamicParams(**{f.name: getattr(dyn, f.name).to(dev) for f in dataclasses.fields(dyn)})
    return dict(camera=cam.to(dev), pre_gn=pre_gn.to(dev), markers_h=markers.to(dev),
                marker_mask=marker_mask.to(dev), downgrade=torch.zeros(m, dtype=torch.bool,
                                                                       device=dev),
                det=det, dyn=dyn, predicted=predicted.to(dev), trust=trust.to(dev),
                config=config)


def fused_args(p: dict) -> tuple:
    """`refine_frame`'s (and `refine_frame_plain`'s) arguments for problem p."""
    cam, c = p["camera"], p["config"]
    scal = torch.stack([cam.fx, cam.fy, cam.cx, cam.cy]).float()
    return (scal, p["pre_gn"], p["markers_h"].T.contiguous(), p["marker_mask"], p["det"].xy,
            p["det"].mask, p["dyn"].back_projection_pixel_tolerance_pf, p["dyn"].jump_threshold,
            p["predicted"], p["trust"], c.gn_max_iterations, c.gn_convergence_tol,
            c.gn_residual_gate, c.gn_step_radius, c.jump_translation_radius,
            c.gn_hypotheses > 1)


def chain_args(p: dict) -> tuple:
    """`refine_hypotheses`' arguments for problem p."""
    return (p["camera"], p["pre_gn"], p["markers_h"], p["marker_mask"], p["downgrade"], p["det"],
            p["dyn"], p["predicted"], p["trust"], p["config"])
