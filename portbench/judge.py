"""Whether what the timed path produced is correct.

The window's frames are sampled while it runs (`Sampler`): a few frames
drawn from the seed, a few of the frames that resampled, a few on which
some target's flag was not PF_SUCCESS, and the frame with the most PF
passes, each with the tracker's state before it, its state and result
after it, and the pose the benchmark read back.  The first frame of the
run (the init branch) is kept too, and the state it started from is held
to the one the reference works out from the seed.  Once the window has
closed, `judge` recomputes each kept frame with the plain reference
(`reference.track.Reference`) from the state before it, stage by stage,
compares every field of the state it hands on, and takes the largest gap
of each reading against the configuration's limit.

With `control="bf16"` the judged side is not the program but the
reference itself with every value it hands on rounded to bfloat16 and its
resampler's CDF scanned in bfloat16: the control, which has to come out as
not correct.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from reference.track import READINGS, Readings, Reference
from reference.utils import prng
from reference.utils.flags import FailFlag

SAMPLED_FRAMES = 6  # drawn from the seed over the whole window
SAMPLED_RESAMPLING = 4  # drawn from the frames on which kernel C ran
SAMPLED_OFF_PATH = 3  # drawn from the frames on which some flag was not PF_SUCCESS


class Sampler:
    """Reservoirs of window frames, drawn from `seed`."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng([seed & (2**64 - 1), 7])
        self.any, self.resampling, self.off_path = [], [], []
        self.seen_any = self.seen_resampling = self.seen_off_path = 0
        self.longest = None  # (passes, frame)

    def _offer(self, pool: list, seen: int, cap: int, frame) -> None:
        if len(pool) < cap:
            pool.append(frame)
        else:
            j = int(self.rng.integers(0, seen))
            if j < cap:
                pool[j] = frame

    def offer(self, frame: dict, passes: int, resampled: bool, off_path: bool = False) -> None:
        self.seen_any += 1
        self._offer(self.any, self.seen_any, SAMPLED_FRAMES, frame)
        if resampled:
            self.seen_resampling += 1
            self._offer(self.resampling, self.seen_resampling, SAMPLED_RESAMPLING, frame)
        if off_path:
            self.seen_off_path += 1
            self._offer(self.off_path, self.seen_off_path, SAMPLED_OFF_PATH, frame)
        if self.longest is None or passes > self.longest[0]:
            self.longest = (passes, frame)

    def frames(self) -> list:
        out, seen = [], set()
        for f in (self.any + self.resampling + self.off_path
                  + ([self.longest[1]] if self.longest else [])):
            if id(f) not in seen:
                seen.add(id(f))
                out.append(f)
        return sorted(out, key=lambda f: f["k"])


def target_view(obj, i: int | None):
    """Target i's fields of a (stacked) state or result, or all of one
    target's when `i` is None."""
    return SimpleNamespace(**{k: (v if i is None else v[i]) for k, v in vars(obj).items()})


def _as_given(out) -> tuple:
    """A reference step's state as the judged side's (state, result)."""
    res = SimpleNamespace(pose=out.current_pose, detections_xy=out.det.xy,
                          detections_mask=out.det.mask)
    return out, res


def flag_name(flag) -> str:
    try:
        return FailFlag(int(flag)).name
    except ValueError:
        return str(int(flag))


def start_keys(seed: int, n_targets: int) -> list:
    """Each target's first key: `prng_key(seed)`, split once per target
    when there are several."""
    key = prng.prng_key(seed)
    return [key] if n_targets == 1 else prng.split(key, n_targets)


def judge(frames: list, image_of, config: dict, markers_t: list, device,
          control: str | None = None, tracker: dict | None = None,
          seed: int | None = None) -> Readings:
    """Recompute every kept frame (dicts of k, idx, t, prev, state, result,
    packed) and return the largest gaps; `image_of(idx)` gives the frame.
    `tracker` is the tracker settings as run (the configuration's when
    None); with `seed`, the state that frame 0 started from is held to the
    one the seed gives."""
    n_targets = len(markers_t)
    settings = config["tracker"] if tracker is None else tracker
    refs = [Reference(config["camera"], m, np.ones(m.shape[0], bool), settings, device)
            for m in markers_t]
    keys = start_keys(seed, n_targets) if seed is not None else None
    total = Readings()
    for f in frames:
        image = image_of(f["idx"])
        for i, ref in enumerate(refs):
            ti = None if n_targets == 1 else i
            prev = target_view(f["prev"], ti)
            if f["k"] == 0 and keys is not None:
                ref.judge_start(prev, keys[i], total)
            name = flag_name(f["packed"][i, 17])
            total.branches[name] = total.branches.get(name, 0) + 1
            if control == "bf16":
                fake, _ = ref.step(prev, image, f["t"], None, torch.bfloat16)
                given = _as_given(fake)
            else:
                res = target_view(f["result"], ti)
                res.host_pose = f["packed"][i, :16]
                given = (target_view(f["state"], ti), res)
            _, rd = ref.step(prev, image, f["t"], given)
            total.merge(rd)
    return total


def checks(readings: Readings, limits: dict) -> tuple[bool, dict]:
    """(correct, {reading: {"value", "limit"}}): correct when at least one
    frame was judged and every reading is within its limit."""
    out = {name: {"value": readings.values[name], "limit": limits.get(name)} for name in READINGS}
    ok = readings.frames > 0 and all(
        c["limit"] is not None and c["value"] <= c["limit"] for c in out.values())
    return ok, out
