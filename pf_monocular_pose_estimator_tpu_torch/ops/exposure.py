"""Online exposure-time control as a pure state machine (port of
`ops/exposure.py`).

The blob-area / ROI-area fraction is tracked across frames; after more
than 500 consecutive low (high) frames the recommended exposure steps up
(down) by 20% of `expose_time_base` and both counters reset.  The tracker
keeps the three fields flattened in its state (`exposure_counter_increase`,
`exposure_counter_decrease`, `exposure_us`); the host may apply
`FrameResult.exposure_us` to whatever camera it drives.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

LOW_FRACTION = 0.013
HIGH_FRACTION = 0.037
HYSTERESIS_FRAMES = 500
STEP_FRACTION = 0.2


class ExposureState(NamedTuple):
    counter_increase: torch.Tensor  # int32
    counter_decrease: torch.Tensor  # int32
    exposure_us: torch.Tensor  # float32, the current recommendation


def exposure_control(state: ExposureState, blob_area_sum: torch.Tensor, roi_area: torch.Tensor,
                     expose_time_base: float, any_detections: torch.Tensor) -> ExposureState:
    """Advance the exposure state machine by one frame (no host read)."""
    frac = blob_area_sum / torch.clamp(roi_area, min=1.0)
    low = any_detections & (frac < LOW_FRACTION)
    high = any_detections & (frac > HIGH_FRACTION)
    inc = state.counter_increase + low.to(torch.int32)
    dec = state.counter_decrease + high.to(torch.int32)
    fire_inc = inc > HYSTERESIS_FRAMES
    fire_dec = dec > HYSTERESIS_FRAMES
    step = STEP_FRACTION * expose_time_base
    exposure = torch.where(fire_inc, state.exposure_us + step,
                           torch.where(fire_dec, state.exposure_us - step, state.exposure_us))
    reset = fire_inc | fire_dec
    zero = torch.zeros_like(inc)
    return ExposureState(torch.where(reset, zero, inc), torch.where(reset, zero, dec), exposure)
