"""The benchmark's plain reference of one tracker frame, and its judge.

`Reference.step(prev, image, t)` runs one frame of the tracker in plain
PyTorch, from a state `prev`: the init branch, then, as the configuration's
`use_particle_filter` chooses, the particle-filter track branch (ESS-gated
resampling and Gauss-Newton over 2M+1 hypotheses) or the IPE track branch
(nearest-neighbour correspondences checked by P3P consensus, one-pose
Gauss-Newton, the brute-force initialisation when the check fails).  It is
the frozen plain path of the port (`reference/*`, no kernel), with the host
control flow of `tracker/step.py::Tracker` for the options a benchmark
configuration may set (no fault injection, exposure control, ego-motion,
mesh or debug switches).

With `given` (the judged side's state and result after the same frame),
each stage runs on the judged side's input to that stage and its output
is measured against the judged side's:

  * detection (kernel A): the detections and the ROI from `prev` and the
    frame;
  * the PF passes (kernel B): the bank that entered resampling and the
    normalised weights, from `prev` and the judged detections;
  * resampling (kernel C): the resampled bank, from the judged bank and
    weights;
  * the refine (kernel D): the published pose and its covariance, from the
    judged detections and the particle the judged resampling copied most
    (the reference's own pick when the frame did not resample); on an IPE
    frame, from the judged detections and the reference's own consensus
    or initialisation;
  * the frame's fail flag and update flag;
  * every field that the state hands on to the next frame: the key, the
    counters and the two times exactly, the current, previous and predicted
    poses at the pose readings, the covariance, bank, resampled bank and
    weights at theirs, and the fields of options no benchmark configuration
    sets, which a frame leaves as they were.

So one stage's rounding is not carried into the next, and every reading is
that stage's own gap.  An IPE frame hands on the bank, the resampled bank
and the weights as it was given them.  With `low=torch.bfloat16` (the
control) every value a stage hands on is rounded to bfloat16 and the
resampler scans its CDF in bfloat16.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

from .geometry.camera import Camera, project
from .geometry.se3 import predict_constant_velocity
from .ops.blob import Detections, determine_roi, find_leds, grow_roi
from .pf.propagate import NoiseBounds, propagation_noise_factors
from .pf.refine import gauss_newton_refine
from .pf.refine_kernel import gauss_newton_refine_batched
from .pf.soa import pick_lane, stratified_resample_soa, unpack
from .pf.step_kernel import fused_propagate_weight, resample_gather
from .pf.weight import weight_particles
from .tracker.check import check_correspondences
from .tracker.initialise import InitResult, argsort_stable, fill_bank_with_seeds, initialise
from .tracker.short_p3p import short_p3p
from .utils import prng
from .utils.config import TrackerConfig
from .utils.dynamic import DynamicParams
from .utils.flags import FailFlag
from .utils.sync import HostReads

_F32 = np.float32
READINGS = ("det_px", "det_slots", "roi_px", "bank", "weights", "resampled", "pose_mm",
            "rot_deg", "cov", "flags", "carried")
ADDED = ("det_slots", "flags", "carried")  # counts over the frames judged, not gaps
# the state's fields that the next frame starts from, compared exactly
CARRIED_EXACT = ("key", "it_since_initialized", "uncertainty", "coast_frames", "degraded_frames",
                 "time_current", "time_previous")
# fields of options that no benchmark configuration sets: a frame leaves them as they were
UNTOUCHED = ("resample_clipped", "obs_cam_old", "change_cam_pose", "time_obs_act",
             "cam_time_shift", "exposure_counter_increase", "exposure_counter_decrease",
             "exposure_us")
POSES = ("current_pose", "previous_pose", "predicted_pose")
INFINITE = 1e300  # an infinite or NaN gap, as a number JSON can carry


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest absolute difference of two tensors (float64); entries that
    are equal, infinities and NaNs included, differ by 0, and an infinity or
    NaN against anything else by INFINITE."""
    a = torch.as_tensor(a).detach().double().cpu()
    b = torch.as_tensor(b).detach().double().cpu()
    if not a.numel():
        return 0.0
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = torch.where(same, torch.zeros_like(a), torch.abs(a - b))
    return float(torch.max(torch.nan_to_num(d, nan=INFINITE, posinf=INFINITE)))


def _scale(x: torch.Tensor) -> float:
    """Largest finite magnitude of x (1e-30 at least)."""
    x = torch.as_tensor(x).detach().double().abs()
    finite = x[torch.isfinite(x)]
    return max(float(finite.max()) if finite.numel() else 0.0, 1e-30)


def rotation_gap_deg(r1: np.ndarray, r2: np.ndarray) -> float:
    """Angle of r1 r2^T in degrees, from the float64 chordal distance."""
    chord = np.linalg.norm(np.asarray(r1, np.float64) - np.asarray(r2, np.float64))
    return math.degrees(2.0 * math.asin(min(1.0, chord / (2.0 * math.sqrt(2.0)))))


def most_resampled(resampled16: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """The particle that stratified resampling copied most often: its
    ancestors do not decrease, so each ancestor's copies are one run of
    equal lanes, and the first longest run is `argmax(counts)`'s.  Rows 12-15
    are `pose`'s."""
    top = resampled16[:12]
    new_run = torch.cat([torch.ones(1, dtype=torch.bool, device=top.device),
                         torch.any(top[:, 1:] != top[:, :-1], dim=0)])
    run_id = torch.cumsum(new_run.to(torch.int64), 0) - 1
    longest = torch.argmax(torch.bincount(run_id))
    lane = torch.argmax((run_id == longest).to(torch.int32))
    return torch.cat([top[:, lane], pose.reshape(16)[12:]]).reshape(4, 4)


def initial_state(n_particles: int, key, width: int, height: int,
                  expose_time_base: float = 2000.0) -> SimpleNamespace:
    """The state a tracker starts from, worked out here: identity poses and
    bank, uniform weights, counters at 0, the whole frame as ROI, times 0
    and -1, the threefry `key`."""
    eye = torch.eye(4).reshape(16, 1)
    return SimpleNamespace(
        key=torch.tensor([int(key[0]), int(key[1])], dtype=torch.int64),
        current_pose=torch.eye(4), previous_pose=torch.eye(4), predicted_pose=torch.eye(4),
        covariance=torch.eye(6), bank=eye.repeat(1, n_particles),
        resampled=eye.repeat(1, n_particles),
        weights=torch.full((n_particles,), 1.0 / n_particles),
        it_since_initialized=0, uncertainty=0, degraded_frames=0, coast_frames=0,
        resample_clipped=0, roi=torch.tensor([0.0, 0.0, float(width), float(height)]),
        time_current=torch.tensor(0.0), time_previous=torch.tensor(-1.0), fail_flag=-10,
        pose_updated=False, num_gn_iterations=0, obs_cam_old=torch.eye(4),
        change_cam_pose=torch.eye(4), time_obs_act=torch.tensor(0.0),
        cam_time_shift=torch.tensor(1.0), exposure_counter_increase=0,
        exposure_counter_decrease=0, exposure_us=torch.tensor(expose_time_base))


def same(a, b) -> bool:
    """Equal, NaNs included, after both are taken to float64 on the CPU."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return a.shape == b.shape and _gap(a, b) == 0.0


class Readings:
    """The largest gap of each reading over the frames judged, and the
    names of the carried fields that differed."""

    def __init__(self):
        self.values = dict.fromkeys(READINGS, 0.0)
        self.frames = 0
        self.mismatched: set = set()
        self.branches: dict = {}  # the judged frames' flags, a count each

    def count(self, name: str, field: str):
        """One more carried field (or frame) that differs."""
        self.values[name] += 1
        self.mismatched.add(field)

    def put(self, name: str, value: float):
        v = float(value)
        if not math.isfinite(v):
            v = INFINITE
        self.values[name] = max(self.values[name], v)

    def merge(self, other: "Readings"):
        """Largest gaps over both; mismatched frames and slots add up."""
        for k, v in other.values.items():
            self.put(k, self.values[k] + v if k in ADDED else v)
        self.frames += other.frames
        self.mismatched |= other.mismatched


class Reference:
    """One target's plain tracker: camera (a dict of fx, fy, cx, cy, dist,
    width, height), markers_h (M, 4), marker_mask (M,), the configuration's
    overrides of `TrackerConfig`, on `device`."""

    def __init__(self, camera: dict, markers_h, marker_mask, overrides: dict, device):
        self.device = torch.device(device)
        self.config = c = TrackerConfig(**{k: tuple(v) if isinstance(v, list) else v
                                           for k, v in overrides.items()})
        self.camera = Camera.create(camera["fx"], camera["fy"], camera["cx"], camera["cy"],
                                    camera["dist"], camera["width"], camera["height"],
                                    device=self.device)
        self.markers_h = torch.as_tensor(markers_h, dtype=torch.float32).to(self.device)
        self.marker_mask = torch.as_tensor(marker_mask).to(torch.bool).to(self.device)
        self.n_markers = int(self.marker_mask.sum())
        m = self.markers_h.shape[0]
        down = list(c.marker_downgrade) + [False] * (m - len(c.marker_downgrade))
        self.downgrade = torch.tensor(down[:m], dtype=torch.bool, device=self.device)
        self.eye4 = torch.eye(4, device=self.device)
        self.dyn = DynamicParams.from_config(c, self.device)
        self.params = c.blob_params()
        self.host = HostReads()

    def _t(self, v, dtype=torch.float32):
        return torch.tensor(v, dtype=dtype, device=self.device)

    def _detect(self, image, roi, min_a, max_a):
        d = self.dyn
        return find_leds(image, roi, self.params, self.camera, min_a, max_a,
                         threshold=d.threshold_value, wh_distortion=d.max_width_height_distortion,
                         circ_distortion=d.max_circular_distortion, host=self.host)

    def _adaptive_blob_areas(self, pred_dist):
        c, d = self.config, self.dyn
        slope = c.blob_area_distance_slope
        min_a = torch.clamp(torch.minimum(d.min_blob_area, d.min_blob_area - slope * (pred_dist - 1.0)),
                            min=c.abs_min_blob_area)
        max_a = torch.clamp(torch.minimum(d.max_blob_area, d.max_blob_area - slope * (pred_dist - 1.0)),
                            min=c.abs_max_blob_area)
        return min_a, max_a

    def _judge_detections(self, det: Detections, roi, given, rd: Readings, round_to):
        """Detection stage: measure against the judged side's detections and
        ROI, and hand on the judged side's (or this side's, rounded)."""
        if given is None:
            xy = round_to(det.xy)
            return Detections(xy=xy, xy_distorted=det.xy_distorted, mask=det.mask, area=det.area,
                              occluded=det.occluded, injected=det.injected)
        g_state, g_res = given
        both = det.mask & g_res.detections_mask.to(self.device)
        rd.put("det_slots", int(torch.sum(det.mask != g_res.detections_mask.to(self.device))))
        rd.put("det_px", _gap(torch.where(both[:, None], det.xy, 0.0),
                              torch.where(both[:, None], g_res.detections_xy.to(self.device), 0.0)))
        rd.put("roi_px", _gap(roi, g_state.roi))
        return Detections(xy=g_res.detections_xy.to(self.device), xy_distorted=det.xy_distorted,
                          mask=g_res.detections_mask.to(self.device), area=det.area,
                          occluded=det.occluded, injected=det.injected)

    def _judge_outputs(self, out, given, rd: Readings):
        """The frame's outputs: the published pose (the judged side's host
        copy when it gives one), its covariance and the two flags."""
        g_state, g_res = given
        pose = getattr(g_res, "host_pose", None)
        pose = g_res.pose if pose is None else pose
        pose = torch.as_tensor(pose).double().cpu().reshape(4, 4).numpy()
        ref = out.current_pose.double().cpu().numpy()
        if bool(out.pose_updated) or bool(torch.as_tensor(g_state.pose_updated)):
            rd.put("pose_mm", 1e3 * float(np.linalg.norm(pose[:3, 3] - ref[:3, 3])))
            rd.put("rot_deg", rotation_gap_deg(pose[:3, :3], ref[:3, :3]))
            rd.put("cov", _gap(out.covariance, g_state.covariance) / _scale(out.covariance))
        if not (int(out.fail_flag) == int(g_state.fail_flag)
                and bool(out.pose_updated) == bool(torch.as_tensor(g_state.pose_updated))):
            rd.count("flags", "fail_flag/pose_updated")

    def _judge_carried(self, prev, out, given, rd: Readings):
        """Every field that the state hands on to the next frame."""
        g = given[0]
        for name in CARRIED_EXACT:
            if not same(getattr(out, name), getattr(g, name)):
                rd.count("carried", name)
        for name in UNTOUCHED:
            if hasattr(g, name) and hasattr(prev, name) and not same(getattr(prev, name),
                                                                     getattr(g, name)):
                rd.count("carried", name)
        for name in POSES:
            ref = torch.as_tensor(getattr(out, name)).double().cpu().numpy()
            got = torch.as_tensor(getattr(g, name)).double().cpu().numpy()
            rd.put("pose_mm", 1e3 * float(np.linalg.norm(got[:3, 3] - ref[:3, 3])))
            rd.put("rot_deg", rotation_gap_deg(got[:3, :3], ref[:3, :3]))
        rd.put("cov", _gap(out.covariance, g.covariance) / _scale(out.covariance))
        rd.put("bank", _gap(out.bank, g.bank))
        rd.put("resampled", _gap(out.resampled, g.resampled))
        rd.put("weights", _gap(out.weights, g.weights) / _scale(out.weights))

    # ------------------------------------------------------------- frame
    def step(self, prev, image, t: float, given=None, low=None):
        """-> (state after the frame, Readings).  `prev` and `given` hold the
        tracker state's fields (and `given[1]` the frame result's).  With
        `low` (a dtype: the control), every value a stage hands on is rounded
        to it and the resampler scans its CDF in it."""
        round_to = (lambda x: x) if low is None else (
            lambda x: x.to(low).to(x.dtype) if x.is_floating_point() else x)
        rd = Readings()
        rd.frames = 1
        image = image.to(self.device).float()
        t_d = torch.as_tensor(t, dtype=torch.float32).to(self.device)
        counters = [int(x) for x in torch.stack([
            torch.as_tensor(prev.it_since_initialized), torch.as_tensor(prev.uncertainty),
            torch.as_tensor(prev.coast_frames), torch.as_tensor(prev.degraded_frames)]).tolist()]
        s = SimpleNamespace(**{k: getattr(prev, k) for k in (
            "key", "current_pose", "previous_pose", "predicted_pose", "covariance", "bank",
            "resampled", "weights", "roi", "time_current", "time_previous")})
        s.fail_flag, s.pose_updated, s.num_gn_iterations = -10, False, 0
        if counters[0] < 1:
            s = self._init_branch(s, image, t_d, counters, given, rd, round_to)
        elif self.config.use_particle_filter:
            s = self._track_branch(s, image, t_d, counters, given, rd, round_to, low)
        else:
            s = self._ipe_branch(s, image, t_d, counters, given, rd, round_to)
        s.fail_flag = int(s.fail_flag)
        s.pose_updated = bool(s.pose_updated)
        if given is not None:
            self._judge_outputs(s, given, rd)
            self._judge_carried(prev, s, given, rd)
        return s, rd

    def judge_start(self, state, key, rd: Readings):
        """The state the run started from against `initial_state` of the
        same key, field by field, exactly."""
        c = self.config
        want = initial_state(c.n_particles, key, self.camera.width, self.camera.height,
                             c.expose_time_base)
        for name, value in vars(want).items():
            if not same(value, getattr(state, name)):
                rd.count("carried", f"start.{name}")

    def _update_pose_times(self, s, t, new_current):
        advance = ((t - s.time_current) > 0.001) | (t < s.time_current)
        s.previous_pose = s.current_pose
        s.current_pose = new_current
        s.time_previous = torch.where(advance, s.time_current, s.time_previous)
        s.time_current = torch.where(advance, t, s.time_current)

    def _counters(self, s, it, unc, coast, deg):
        s.it_since_initialized, s.uncertainty, s.coast_frames, s.degraded_frames = it, unc, coast, deg

    # -------------------------------------------------------------- INIT
    def _init_branch(self, s, image, t, counters, given, rd, round_to):
        c = self.config
        it, unc, coast, deg = counters
        key, _k_faults = prng.split(torch.as_tensor(s.key).tolist())
        s.key = torch.tensor(key, dtype=torch.int64)
        init_needed = (min(self.n_markers, c.pf_init_min_markers)
                       if c.use_particle_filter and c.pf_init_min_markers > 0 else self.n_markers)
        growth = float(_F32(c.roi_uncertainty_growth) * (_F32(1.0) + np.floor(_F32(unc) / _F32(3.0))))
        roi = grow_roi(s.roi, growth, growth, self.camera)
        det = self._detect(image, roi, None, None)
        prev_t = s.current_pose[:3, 3]
        count, prev_norm = self.host(torch.stack([det.count.float(), torch.linalg.norm(prev_t)]))
        had_track = prev_norm > 1e-6
        if count < init_needed and had_track:
            min_a, max_a = self._adaptive_blob_areas(torch.linalg.norm(prev_t))
            det = self._detect(image, roi, min_a, max_a)
        det = s.det = self._judge_detections(det, roi, given, rd, round_to)
        count = self.host(det.count)
        enough = count >= init_needed
        recently = unc < c.init_consistency_uncertainty_cap
        if enough:
            gate_active = had_track and recently
            prefer = torch.cat([prev_t, self._t([float(gate_active)]),
                                s.current_pose[:3, :3].reshape(9)])
            init_res = initialise(self.camera, det, self.markers_h, self.marker_mask, s.bank, c,
                                  self.dyn, prefer_near=prefer, fill_seeds=fill_bank_with_seeds)
        else:
            init_res = InitResult(
                success=self._t(False, torch.bool), pose=torch.eye(4, device=self.device),
                det_for_marker=torch.full((self.markers_h.shape[0],), -1, dtype=torch.int32,
                                          device=self.device),
                bank=s.bank, flag=self._t(int(FailFlag.TOO_FEW_LEDS_INIT), torch.int32))
        if c.init_consistency_radius > 0.0:
            far = torch.linalg.norm(init_res.pose[:3, 3] - prev_t) > c.init_consistency_radius
            if c.init_consistency_rotation_deg > 0.0:
                r_rel = init_res.pose[:3, :3] @ s.current_pose[:3, :3].T
                cos_a = torch.clamp((torch.trace(r_rel) - 1.0) / 2.0, -1.0, 1.0)
                cos_lim = torch.cos(torch.deg2rad(self._t(c.init_consistency_rotation_deg)))
                far = far | (cos_a < cos_lim)
            inconsistent = init_res.success & far & (had_track and recently)
            init_res = init_res._replace(
                success=init_res.success & ~inconsistent,
                flag=torch.where(inconsistent, int(FailFlag.INIT_INCONSISTENT),
                                 init_res.flag).to(torch.int32))
        s.roi = roi
        success, flag = self.host(torch.stack([init_res.success.to(torch.int32), init_res.flag]))
        if success:
            bank = round_to(init_res.bank)
            if given is not None:
                rd.put("bank", _gap(bank, given[0].bank))
            res = self._refine_from(init_res.pose, init_res.det_for_marker, det)
            s.current_pose, s.predicted_pose = init_res.pose, round_to(res.pose)
            s.covariance, s.bank, s.resampled = round_to(res.covariance), bank, bank
            s.pose_updated, s.num_gn_iterations = True, res.num_iterations
            s.fail_flag = int(FailFlag.INIT_SUCCESS)
            self._counters(s, 1, unc, coast, deg)
            self._update_pose_times(s, t, s.predicted_pose)
        else:
            bump = 1 if enough else 2
            if flag == int(FailFlag.INIT_INCONSISTENT):
                bump += c.init_consistency_reject_bump
            s.pose_updated, s.fail_flag = False, flag
            self._counters(s, it, unc + bump, coast, deg)
        return s

    # ------------------------------------------------------------- TRACK
    def _track_branch(self, s, image, t, counters, given, rd, round_to, cdf_dtype):
        c, dyn = self.config, self.dyn
        it, unc, coast, deg = counters
        key, _k_faults, k_resample = prng.split(torch.as_tensor(s.key).tolist(), 3)
        cam_move_inv = self.eye4
        dt_past = s.time_current - s.time_previous
        prediction = predict_constant_velocity(s.previous_pose, s.current_pose, dt_past,
                                               t - s.time_current)
        predicted = cam_move_inv @ (s.current_pose @ prediction)

        s_cap = min(c.roi_particle_subsample, s.weights.shape[0])
        sub = cam_move_inv @ unpack(s.resampled[:, :s_cap]) @ prediction
        pix = torch.cat([project(self.camera, sub, self.markers_h).reshape(-1, 2),
                         project(self.camera, predicted, self.markers_h)])
        pix_mask = torch.cat([self.marker_mask[None, :].expand(s_cap, -1).reshape(-1),
                              self.marker_mask])
        roi = determine_roi(pix, pix_mask, self.camera, c.roi_border_thickness)
        dist_val = torch.clamp(c.roi_distance_gain / torch.clamp(s.current_pose[2, 3], min=0.1),
                               0.0, 100.0)
        roi = round_to(grow_roi(roi, dist_val, dist_val, self.camera))
        min_a, max_a = self._adaptive_blob_areas(torch.linalg.norm(predicted[:3, 3]))
        det = self._detect(image, roi, min_a, max_a)
        if self.host(det.count) < c.min_num_leds_detected:
            roi = round_to(grow_roi(roi, c.roi_retry_growth, c.roi_retry_growth, self.camera))
            det = self._detect(image, roi, min_a, max_a)
        det = s.det = self._judge_detections(det, roi, given, rd, round_to)
        num_led = self.host(det.count)

        tracking = it > 1
        fresh = it == 1
        fac_t, fac_r = propagation_noise_factors(fresh, prediction,
                                                 torch.clamp(t - s.time_current, min=1e-6))
        m_f = _F32(self.n_markers)
        num_led_f = _F32(num_led)
        exit_gate = m_f * min(_F32(c.pf_exit_gate_factor), num_led_f)
        accept_gate = m_f * min(_F32(c.pf_accept_gate_factor), num_led_f)
        noise = NoiseBounds(dyn.min_translation_noise, dyn.max_translation_noise,
                            dyn.min_angular_noise, dyn.max_angular_noise)

        def pf_pass(pf_it: int, k):
            inflation = float(_F32(1.0) + _F32(c.noise_inflation_per_10_iters)
                              * np.floor(_F32(pf_it) / _F32(10.0)))
            apply_pred = tracking and (pf_it % 10 != 0)
            return fused_propagate_weight(
                k, s.resampled, s.current_pose, predicted, prediction, cam_move_inv, noise, fac_t,
                fac_r, tracking, apply_pred, inflation, self.camera, self.markers_h,
                self.marker_mask, det.xy, det.mask, dyn.back_projection_pixel_tolerance_pf,
                dyn.back_projection_pixel_tolerance, self.downgrade, float(m_f), want_pairs=False)

        key, k_loop = prng.split(key)
        s.key = torch.tensor(key, dtype=torch.int64)
        k_rest, k0 = prng.split(k_loop)
        bank16, best_w = pf_pass(0, k0)
        highest = self.host(torch.max(best_w))
        pf_it = 1
        while pf_it < c.pf_max_retries and highest < exit_gate:
            k_rest, k = prng.split(k_rest)
            bank_i, w_i = pf_pass(pf_it, k)
            new_high = self.host(torch.max(w_i))
            if new_high > highest:
                bank16, best_w = bank_i, w_i
            highest = max(highest, new_high)
            pf_it += 1
        highest_t = torch.max(best_w)
        if c.motion_prior_radius > 0.0:
            d = torch.linalg.norm(bank16[[3, 7, 11], :] - predicted[:3, 3][:, None], dim=-2)
            excess = torch.clamp(d - c.motion_prior_radius, min=0.0) / self._t(c.motion_prior_falloff)
            prior = torch.exp(-0.5 * excess * excess)
            small_step = torch.linalg.norm(prediction[:3, 3]) < c.motion_prior_radius
            if tracking:
                best_w = torch.where(small_step, best_w * prior, best_w)
            highest_t = torch.max(best_w)
        w_sum, w_sum2 = torch.sum(best_w), torch.sum(best_w * best_w)
        weights_norm = torch.where(w_sum > 0, best_w / torch.clamp(w_sum, min=1e-12), best_w)
        best_idx = torch.argmax(best_w)
        n_f = self._t(float(best_w.shape[0]))
        ess_frac = (w_sum * w_sum) / (torch.clamp(w_sum2, min=1e-30) * n_f)
        w_sum_h, highest, ess_h = self.host(torch.stack([w_sum, highest_t, ess_frac]))
        accepted = w_sum_h > 0 and highest > accept_gate
        marginal = highest < accept_gate + _F32(c.marginal_margin_factor) * num_led_f

        bank16, weights_norm = round_to(bank16), round_to(weights_norm)
        s.bank, s.roi = bank16, roi
        if not accepted:
            coast_ok = c.pf_coast_frames > 0 and it >= 2 and coast < c.pf_coast_frames
            unc += 1
            it = it if coast_ok else 0
            coast = coast + 1 if coast_ok else 0
            s.fail_flag = int(FailFlag.PF_NO_REASONABLE_PARTICLE)
            s.predicted_pose = pick_lane(bank16, best_idx).reshape(4, 4)
            s.pose_updated, s.weights = False, weights_norm
            self._judge_pf(s.bank, s.weights, given, rd)
            self._counters(s, it, unc, coast, deg)
            return s

        flag = int(FailFlag.PF_SUCCESS)
        coast = 0
        s.pose_updated = False
        if marginal:
            if unc < c.uncertainty_cap:
                unc += 1
                pose_b = pick_lane(bank16, best_idx).reshape(4, 4)
                _, p_b, nc_b = weight_particles(
                    self.camera, pose_b[None], self.markers_h, self.marker_mask, det.xy, det.mask,
                    dyn.back_projection_pixel_tolerance_pf, dyn.back_projection_pixel_tolerance,
                    self.downgrade, self._t(float(m_f)))
                if self.host(nc_b[0]) == 3:
                    p = p_b[0]
                    three = p[argsort_stable((p[:, 0] < 0).to(torch.int32))][:3]
                    res = short_p3p(self.camera, det, self.markers_h, self.marker_mask, three,
                                    bank16, c, dyn, fill_seeds=fill_bank_with_seeds)
                    if self.host(res.success):
                        s.bank = round_to(res.bank)
                        flag = int(FailFlag.SHORT_P3P_SUCCESS)
                    else:
                        it = 0
            else:
                it, unc, flag = 0, 1, int(FailFlag.UNCERTAINTY_REINIT)
        else:
            unc = 1
        if c.degraded_reinit_frames > 0:
            strong = m_f * (m_f + _F32(c.degraded_weight_offset))
            if highest < strong:
                deg += 1
            else:
                deg = max(deg - c.degraded_reset_decay, 0) if c.degraded_reset_decay > 0 else 0
            if deg >= c.degraded_reinit_frames:
                deg, it = 0, 0
                unc = max(c.init_consistency_uncertainty_cap - c.init_consistency_reject_bump - 1, 0)
                flag = int(FailFlag.UNCERTAINTY_REINIT)
        s.fail_flag = flag
        if it > 0:
            s.weights = weights_norm
            self._judge_pf(s.bank, s.weights, given, rd)
            if given is not None:  # resampling and the refine start from the judged bank
                s.bank, s.weights = given[0].bank.to(self.device), given[0].weights.to(self.device)
            jump = self._resample_and_refine(s, k_resample, det, ess_h, best_idx, t, given, rd,
                                             round_to, cdf_dtype)
            it = min(it + 1, 2)
            if jump:
                s.fail_flag = int(FailFlag.PF_JUMP)
        else:
            self._judge_pf(s.bank, None, given, rd)
        self._counters(s, it, unc, coast, deg)
        return s

    # --------------------------------------------------------- IPE TRACK
    # Frozen plain copy of pf_monocular_pose_estimator_tpu_torch/tracker/step.py::
    # Tracker._ipe_branch at c9c60f0 (itself the reference `ipe_track_branch`), without
    # fault injection: nearest-neighbour correspondences from the predicted pose,
    # checked by P3P consensus, then one-pose Gauss-Newton; the brute-force
    # initialisation when the check fails.  The bank, resampled bank and weights
    # pass through unchanged.
    def _ipe_branch(self, s, image, t, counters, given, rd, round_to):
        c, dyn = self.config, self.dyn
        it, unc, coast, deg = counters
        key, _k_faults = prng.split(torch.as_tensor(s.key).tolist())
        s.key = torch.tensor(key, dtype=torch.int64)
        min_a, _ = self._adaptive_blob_areas(torch.linalg.norm(s.predicted_pose[:3, 3]))
        if it >= 2:  # constant-velocity prediction once the track is mature
            dt_past = s.time_current - s.time_previous
            s.predicted_pose = s.current_pose @ predict_constant_velocity(
                s.previous_pose, s.current_pose, dt_past, t - s.time_current)
        pix = project(self.camera, s.predicted_pose, self.markers_h)
        roi = round_to(determine_roi(pix, self.marker_mask, self.camera, c.roi_border_thickness))
        det = self._detect(image, roi, min_a, None)
        if self.host(det.count) < c.min_num_leds_detected:  # search the whole frame once
            roi = self._t([0.0, 0.0, float(self.camera.width), float(self.camera.height)])
            det = self._detect(image, roi, min_a, None)
        det = s.det = self._judge_detections(det, roi, given, rd, round_to)
        s.roi = roi
        if self.host(det.count) < c.min_num_leds_detected:
            s.fail_flag = int(FailFlag.TOO_FEW_MARKERS_DETECTED)
            self._counters(s, it, unc, coast, deg)
            return s

        dd = pix[:, None, :] - det.xy[None, :, :]
        d2 = torch.sum(dd * dd, dim=-1)  # (M, K)
        d2 = torch.where(det.mask[None, :], d2, torch.full((), float("inf"), device=self.device))
        nearest = torch.argmin(d2, dim=-1)
        min_d = torch.sqrt(torch.min(d2, dim=-1).values)
        dfm = torch.where((min_d <= dyn.nearest_neighbour_pixel_tolerance) & self.marker_mask,
                          nearest.to(torch.int32),
                          torch.full((), -1, dtype=torch.int32, device=self.device))
        chk = check_correspondences(self.camera, det.xy, det.mask, self.markers_h,
                                    self.marker_mask, dfm[None], c.min_num_leds_detected, c, dyn)
        if self.host(chk.success[0]):
            res = self._refine_from(chk.pose[0], dfm, det)
            flag = FailFlag.PF_SUCCESS
        else:
            init_res = initialise(self.camera, det, self.markers_h, self.marker_mask, s.bank, c,
                                  dyn, fill_seeds=fill_bank_with_seeds)
            if not self.host(init_res.success):
                s.fail_flag = int(self.host(init_res.flag))
                self._counters(s, 0, unc, coast, deg)
                return s
            res = self._refine_from(init_res.pose, init_res.det_for_marker, det)
            s.current_pose = init_res.pose
            flag = FailFlag.INIT_SUCCESS
        pose = round_to(res.pose)
        s.predicted_pose, s.covariance = pose, round_to(res.covariance)
        s.pose_updated, s.num_gn_iterations = True, res.num_iterations
        s.fail_flag = int(flag)
        self._counters(s, min(it + 1, 2), unc, coast, deg)
        self._update_pose_times(s, t, pose)
        return s

    def _refine_from(self, pose0, det_for_marker, det):
        """One-pose Gauss-Newton from `pose0` on the pairs (marker m,
        detection det_for_marker[m])."""
        c = self.config
        m = self.markers_h.shape[0]
        corr = torch.stack([torch.arange(m, dtype=torch.int32, device=self.device),
                            det_for_marker], -1)
        corr_mask = (det_for_marker >= 0) & self.marker_mask
        return gauss_newton_refine(self.camera, pose0, self.markers_h, det.xy, corr, corr_mask,
                                   c.gn_max_iterations, c.gn_convergence_tol)

    def _judge_pf(self, bank, weights, given, rd):
        """PF stage: the bank that entered resampling and its weights."""
        if given is None:
            return
        rd.put("bank", _gap(bank, given[0].bank))
        if weights is not None:
            rd.put("weights", _gap(weights, given[0].weights) / _scale(weights))

    def _resample_and_refine(self, s, key, det, ess_h, best_idx, t, given, rd, round_to,
                             cdf_dtype):
        c, dyn = self.config, self.dyn
        dev = self.device
        bank16, weights_norm = s.bank, s.weights
        if c.resample_min_ess <= 0.0 or ess_h < c.resample_min_ess:
            anc, _counts, most = stratified_resample_soa(key, weights_norm, cdf_dtype)
            resampled16 = round_to(resample_gather(bank16, anc))
        else:
            resampled16, most = bank16, best_idx
        pre_gn = pick_lane(bank16, most).reshape(4, 4)
        if given is not None:
            rd.put("resampled", _gap(resampled16, given[0].resampled))
            if resampled16 is not bank16:  # the refine starts where the judged side's did
                pre_gn = most_resampled(given[0].resampled.to(dev), pre_gn)
        tol_pf = dyn.back_projection_pixel_tolerance_pf
        _, pairs_1, _ = weight_particles(self.camera, pre_gn[None], self.markers_h,
                                         self.marker_mask, det.xy, det.mask, tol_pf,
                                         dyn.back_projection_pixel_tolerance, self.downgrade)
        base_pairs = pairs_1[0]
        m_cap = self.markers_h.shape[0]
        marker_ids = torch.arange(m_cap, device=dev)
        minus1 = torch.full((), -1, dtype=torch.int32, device=dev)
        dfm_base = torch.max(torch.where(base_pairs[:, 0][None, :] == marker_ids[:, None],
                                         base_pairs[:, 1][None, :], minus1), dim=1).values
        if c.gn_hypotheses <= 1:
            dfm_h = dfm_base[None]
        else:
            uv0 = project(self.camera, pre_gn, self.markers_h)
            dd = det.xy[None, :, :] - uv0[:, None, :]
            d2m = torch.sum(dd * dd, dim=-1)
            big = torch.full((), 1e12, device=dev)
            d2m = torch.where(det.mask[None, :], d2m, big)
            bound = torch.clamp(dfm_base, 0, det.xy.shape[0] - 1)
            d2_alt = torch.where(torch.arange(det.xy.shape[0], device=dev)[None, :] == bound[:, None],
                                 big, d2m)
            alt_min = torch.min(d2_alt, dim=1).values
            alt = torch.argmax((d2_alt == alt_min[:, None]).to(torch.int32), dim=1).to(torch.int32)
            alt_ok = (alt_min <= tol_pf * tol_pf) & (dfm_base >= 0)
            alt = torch.where(alt_ok, alt, dfm_base)
            eye_m = torch.eye(m_cap, dtype=torch.bool, device=dev)
            swap_h = torch.where(eye_m, alt[None, :], dfm_base[None, :])
            drop_h = torch.where(eye_m, minus1, dfm_base[None, :])
            dfm_h = torch.cat([dfm_base[None], swap_h, drop_h])
        corr_masks = (dfm_h >= 0) & self.marker_mask[None, :]
        n_h = corr_masks.shape[0]
        poses0 = pre_gn[None].expand(n_h, 4, 4)
        res = gauss_newton_refine_batched(self.camera, poses0, self.markers_h, det.xy, dfm_h,
                                          corr_masks, c.gn_max_iterations, c.gn_convergence_tol)
        n_pairs = torch.sum(corr_masks, dim=-1).float()
        local = torch.linalg.norm(res.pose[:, :3, 3] - pre_gn[:3, 3][None], dim=-1) <= c.gn_step_radius
        feasible = (res.max_residual <= c.gn_residual_gate) & (n_pairs > 0) & local
        pref = n_pairs - 1e-3 * torch.arange(n_h, dtype=torch.float32, device=dev)
        pref = torch.where(feasible, pref, torch.full((), float("-inf"), device=dev))
        any_feasible = torch.any(feasible)
        best_h = torch.where(any_feasible, torch.argmax(pref),
                             torch.zeros((), dtype=torch.int64, device=dev))
        pick = lambda x: x.index_select(0, best_h.reshape(1))[0]
        pose = round_to(torch.where(any_feasible, pick(res.pose), pre_gn))
        jump = bool(torch.max(torch.abs(pose[:3, :3] - pre_gn[:3, :3])) >= dyn.jump_threshold)
        s.predicted_pose, s.covariance = pose, round_to(pick(res.covariance))
        s.pose_updated, s.num_gn_iterations = True, pick(res.num_iterations)
        s.resampled, s.weights, s.bank = resampled16, weights_norm, bank16
        self._update_pose_times(s, t, pose)
        return jump

