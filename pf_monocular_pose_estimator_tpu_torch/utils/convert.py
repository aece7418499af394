"""Converters between the reference's state and parameters and the port's.

This system has no learned weights; what carries over from the JAX
package is its tracker state, camera, markers and runtime parameters.
Inputs are numpy arrays (or anything `np.asarray` takes), e.g.
`{k: np.asarray(v) for k, v in state._asdict().items()}`, so this module
never imports jax.  The reference nests `ExposureState` in `exposure`;
it may arrive as an object with `counter_increase` / `counter_decrease` /
`exposure_us` attributes or as the 3-tuple of their values.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry.camera import Camera
from ..tracker.state import TargetState
from .dynamic import DynamicParams

_EXPOSURE = ("counter_increase", "counter_decrease", "exposure_us")
_STATE_EXPOSURE = ("exposure_counter_increase", "exposure_counter_decrease", "exposure_us")


def _tensor(v, device) -> torch.Tensor:
    a = np.asarray(v)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def state_from_reference(fields: dict, device="cpu") -> TargetState:
    """Reference `TargetState` fields (numpy) -> the port's `TargetState`.
    A multi-target state (leaves with a leading target axis, as the
    reference's `vmap`ped states) keeps that axis on every leaf: key (T, 2),
    exposure fields (T,)."""
    fields = dict(fields)
    exposure = fields.pop("exposure")
    values = (
        [getattr(exposure, n) for n in _EXPOSURE] if hasattr(exposure, "exposure_us")
        else list(exposure)
    )
    out = {k: _tensor(v, device) for k, v in fields.items() if k != "key"}
    out["key"] = torch.from_numpy(np.asarray(fields["key"]).astype(np.int64))
    for name, v, dtype in zip(_STATE_EXPOSURE, values, (np.int32, np.int32, np.float32)):
        out[name] = torch.from_numpy(np.asarray(v).astype(dtype)).to(device)
    return TargetState(**out)


def state_to_reference(state: TargetState) -> dict:
    """The port's `TargetState` -> reference field dict of numpy arrays
    (`exposure` as a (counter_increase, counter_decrease, exposure_us) tuple),
    single or multi-target."""
    out = {}
    for f in dataclasses.fields(state):
        if f.name in _STATE_EXPOSURE:
            continue
        out[f.name] = getattr(state, f.name).detach().cpu().numpy()
    out["key"] = out["key"].astype(np.uint32)
    out["exposure"] = tuple(getattr(state, n).detach().cpu().numpy() for n in _STATE_EXPOSURE)
    return out


def camera_from_reference(fields: dict, device="cpu") -> Camera:
    """Reference `Camera` fields (fx, fy, cx, cy, dist, width, height)."""
    return Camera.create(
        float(np.asarray(fields["fx"])), float(np.asarray(fields["fy"])),
        float(np.asarray(fields["cx"])), float(np.asarray(fields["cy"])),
        np.asarray(fields["dist"], np.float32), int(fields["width"]), int(fields["height"]),
        device=device,
    )


def dynamic_from_reference(fields: dict, device="cpu") -> DynamicParams:
    """Reference `DynamicParams` fields -> the port's."""
    return DynamicParams(
        **{f.name: torch.tensor(float(np.asarray(fields[f.name])), dtype=torch.float32,
                                device=device)
           for f in dataclasses.fields(DynamicParams)}
    )


def markers_from_reference(markers_h, marker_mask, device="cpu"):
    """(M, 4) homogeneous markers and (M,) mask -> float32 / bool tensors."""
    return (torch.as_tensor(np.asarray(markers_h, np.float32)).to(device),
            torch.as_tensor(np.asarray(marker_mask, bool)).to(device))
