"""Multi-target tracking: a leading target axis (port of `tracker/multi.py`).

Targets with fewer markers are padded to a common M with a mask.  States
and results carry the target axis on every leaf, as the reference's
`vmap`ped states do, so `utils.convert` and `utils.checkpoint` take them
leaf for leaf.  Each target steps through its own `Tracker` (its marker
set and mask, its own host branches), so every target runs the main
path's kernels: A on the shared frame (in full while it initialises), B,
C and D.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..geometry.camera import Camera
from ..utils import prng, trace
from ..utils.config import TrackerConfig
from ..utils.sync import HostReads
from .state import FrameResult, TargetState
from .step import Tracker


def pad_marker_sets(marker_sets: Sequence) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-target (M_i, 4) marker arrays -> ((T, M_max, 4) float32,
    (T, M_max) bool) CPU tensors; padded rows keep w = 1 so their projection
    stays finite."""
    sets = [np.asarray(m.detach().cpu() if torch.is_tensor(m) else m, np.float32)
            for m in marker_sets]
    m_max = max(m.shape[0] for m in sets)
    out = np.zeros((len(sets), m_max, 4), np.float32)
    mask = np.zeros((len(sets), m_max), bool)
    for i, m in enumerate(sets):
        out[i, : m.shape[0]] = m
        mask[i, : m.shape[0]] = True
        out[i, m.shape[0]:, 3] = 1.0
    return torch.from_numpy(out), torch.from_numpy(mask)


def stack_states(states: Sequence[TargetState]) -> TargetState:
    """Per-target states -> one state with a leading target axis on every leaf."""
    return TargetState(**{f.name: torch.stack([getattr(s, f.name) for s in states])
                          for f in dataclasses.fields(TargetState)})


def target_state(states: TargetState, i: int) -> TargetState:
    """Target i's state (views of the stacked leaves)."""
    return TargetState(**{f.name: getattr(states, f.name)[i]
                          for f in dataclasses.fields(TargetState)})


def stack_results(results: Sequence[FrameResult]) -> FrameResult:
    return FrameResult(**{f.name: torch.stack([getattr(r, f.name) for r in results])
                          for f in dataclasses.fields(FrameResult)})


def create_states(n_targets: int, n_particles: int, seed: int = 0, image_size=(752, 480),
                  device="cuda") -> TargetState:
    """Initial states of `n_targets` targets on `device` (the card unless
    asked otherwise): target i's key is `split(prng_key(seed), n_targets)[i]`,
    as the reference's `jax.random.split`."""
    keys = prng.split(prng.prng_key(seed), n_targets)
    return stack_states([TargetState.create(n_particles, k, image_size, device) for k in keys])


class MultiTracker:
    """`step(states, image, t) -> (states', results)` over targets; `results`
    is a `FrameResult` stacked over targets.

    `trackers` are the per-target steps, one after another on the shared
    frame.  They share one `HostReads`, so `host.count / frames` is the
    device -> host syncs per multi-target frame (and `host.uploads / frames`
    the host -> device copies).  `gather(results)`, when
    given, completes the stacked results of the targets this process holds
    to every target's (`parallel.mesh.make_sharded_multi_tracker`)."""

    def __init__(self, trackers: Sequence[Tracker], gather=None):
        self.trackers = list(trackers)
        self.gather = gather
        self.host = HostReads()
        for i, tracker in enumerate(self.trackers):
            tracker.host = self.host
            tracker.target = i
        self.frames = 0

    def __call__(self, states: TargetState, image: torch.Tensor, t):
        with self.host, trace.span("multi.frame", self.host, self.frames):
            image = self.host.put(image, self.trackers[0].device, image.dtype)
            outs = [tracker(target_state(states, i), image, t)
                    for i, tracker in enumerate(self.trackers)]
            self.frames += 1
            results = stack_results([r for _, r in outs])
            if self.gather is not None:
                results = self.gather(results)
                self.host.count += 1
            return stack_states([s for s, _ in outs]), results


def make_multi_tracker(camera: Camera, markers_h, marker_masks, config: TrackerConfig,
                       sequential: bool = True, device="cuda") -> MultiTracker:
    """The per-frame step over targets on `device` (the card unless asked
    otherwise): markers_h (T, M, 4), marker_masks (T, M).

    sequential=True is the reference's `lax.map`, the per-object loop its
    CLI takes: each target runs the ordinary tracker with its own marker set
    and mask.  sequential=False is the reference's `vmap`, whose `lax.cond`s
    become selects that run both branches for every target; each target's
    values stay its own all the same, so here the targets step one after
    another through the same tracker and kernels, and the two forms give the
    same states and results."""
    markers_h = torch.as_tensor(markers_h, dtype=torch.float32)
    marker_masks = torch.as_tensor(marker_masks).to(torch.bool)
    trackers = [Tracker(camera, markers_h[i], marker_masks[i], config, device)
                for i in range(markers_h.shape[0])]
    return MultiTracker(trackers)
