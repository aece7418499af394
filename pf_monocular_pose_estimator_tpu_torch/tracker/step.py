"""The per-frame tracking state machine (port of `tracker/step.py`).

The reference compiles a frame into one program, with `lax.cond` /
`lax.while_loop` for its data-dependent control flow.  Here that control
flow runs on the host: the tracker reads the few scalars it branches on
through a counted `HostReads` (one device -> host sync each), and keeps
the small integer counters (`it_since_initialized`, `uncertainty`,
`coast_frames`, `degraded_frames`) as host ints while a frame runs.

Syncs on a tracked frame: the state counters (1), the ROI for the
crop-or-full-frame choice (1), the detection count (1; +2 if the ROI is
grown and detection retried; +1 after fault injection), the best weight
after every PF pass (1 per pass), and the accept / marginal / ESS gates
read together (1).  A marginal frame adds up to two more (short-P3P).
With `use_pallas_resample` a frame that resamples reads the decode's
coverage flag on the host (one more sync).

Every option of `TrackerConfig` runs: the init branch, the particle-filter
track branch with every single-device PF, resample and Gauss-Newton
switch, the IPE track branch (`use_particle_filter=False`), fault
injection, online exposure control, observer ego-motion (`use_cam_pos`,
with the observer pose and its time passed to each step) and the
`debug_skip` stages.

The reference's two SPMD hooks are here too: `pf_fn` takes the place of
the propagate + weight pass and `resample_fn` that of the resampler, and a
tracker built with a particles mesh (`parallel.mesh.make_sharded_tracker`)
keeps its bank in the mesh's sharded layout.  Whatever a frame asks of the
whole bank goes through `self.bank` (`tracker.bank`), whose values are the
same on every rank of the mesh, so every rank takes the same host branches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.camera import Camera, project
from ..geometry.se3 import exp_se3, inverse, log_se3, predict_constant_velocity
from ..ops import detect_kernel
from ..ops.blob import Detections, determine_roi, find_leds, grow_roi
from ..ops.exposure import ExposureState, exposure_control
from ..ops.faults import inject_faults
from ..pf.propagate import NoiseBounds, propagation_noise_factors
from ..pf.refine import gauss_newton_refine
from ..pf.refine_kernel import gauss_newton_refine_batched
from ..pf.resample_kernel import resample_bank
from ..pf.soa import (
    propagate_soa,
    stratified_resample_closed,
    stratified_resample_soa,
    unpack,
    weight_particles_soa,
)
from ..pf.step_kernel import fused_propagate_weight, resample_gather
from ..pf.weight import weight_particles
from ..pf.weight_kernel import check_card_shape, weight_particles_bank
from ..utils import prng
from ..utils.config import TrackerConfig
from ..utils.dynamic import DynamicParams
from ..utils.flags import FailFlag
from ..utils.sync import HostReads
from .bank import WholeBank
from .check import check_correspondences
from .initialise import InitResult, argsort_stable, initialise
from .short_p3p import short_p3p
from .state import FrameResult, TargetState

_F32 = np.float32
# DynamicParams fields the host branches on
_HOST_DYN = ("pf_exit_gate_factor", "pf_accept_gate_factor", "marginal_margin_factor",
             "noise_inflation_per_10_iters")
# The observer camera's mounting rotation, hard-coded as in the reference
# (its `tracker/step.py::_ROT_CAM`).
_ROT_CAM = ((0.0, 1.0, 0.0, 0.0), (0.0, 0.0, 1.0, 0.0), (1.0, 0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0))


def _ego_motion(state: TargetState, t: torch.Tensor, obs_pose: torch.Tensor,
                obs_time: torch.Tensor):
    """Observer-camera ego-motion (reference `tracker/step.py::_ego_motion`):
    the observer's motion between its last two poses, extrapolated to `t`.
    Returns (cam_move_inv, state with the observer fields updated); no
    extrapolation while `t <= obs_time`.  A singular `obs_pose` counts as the
    identity."""
    dev = obs_pose.device
    eye = torch.eye(4, dtype=obs_pose.dtype, device=dev)
    singular = torch.abs(torch.linalg.det(obs_pose)) < 1e-9
    obs_cam = torch.where(singular, eye, obs_pose) @ torch.tensor(_ROT_CAM, dtype=obs_pose.dtype,
                                                                  device=dev)
    new_avail = obs_time > state.time_obs_act
    change = torch.where(new_avail, inverse(state.obs_cam_old) @ obs_cam, state.change_cam_pose)
    obs_cam_old = torch.where(new_avail, obs_cam, state.obs_cam_old)
    shift = torch.where(new_avail, obs_time - state.time_obs_act, state.cam_time_shift)
    time_obs_act = torch.where(new_avail, obs_time, state.time_obs_act)
    ratio = (t - state.time_current) / torch.clamp(shift, min=1e-6)
    cam_move = exp_se3(log_se3(change) * ratio)
    cam_move = torch.where(t <= obs_time, eye, cam_move)
    state = state.replace(obs_cam_old=obs_cam_old, change_cam_pose=change,
                          time_obs_act=time_obs_act, cam_time_shift=shift)
    return inverse(cam_move), state


def check_card_limits(config: TrackerConfig, n_markers: int) -> None:
    """Raise a ValueError that names the limit where the card's kernels do
    not take this configuration with `n_markers` marker rows: B, E and D
    take 1 to 32 markers and B and E 1 to 128 detections; A takes 0 to 32
    `cc_sweeps` and a top-k (`max_detections`) of 1 to min(128, crop
    pixels).  The CPU takes any."""
    check_card_shape("Tracker", n_markers, config.max_detections)
    crop = config.roi_crop
    pixels = int(crop[0]) * int(crop[1]) if crop is not None else detect_kernel.MAX_TOPK
    detect_kernel.check_card_shape(config.cc_sweeps, config.max_detections, pixels)


class Tracker:
    """`step(state, image, t, obs_pose=None, obs_time=None, dyn=None) ->
    (state', FrameResult)` on one device.

    With `use_cam_pos`, `obs_pose` (4, 4) is the observer's pose and
    `obs_time` its time stamp (the identity and 0 when not given); `dyn`
    overrides the runtime-tunable parameters of the config.

    `host.count` counts the device -> host reads so far and `frames` the
    frames stepped, so `host.count / frames` is the syncs per frame.  With
    `use_pallas_resample`, `decoded_frames` and `fallback_frames` list the
    frames whose resampling took the decode's result and the sort path's.
    The tracker runs on the card unless `device` says otherwise.

    `pf_fn` (the reference's hook: one propagate + weight pass, called with
    the arguments of `fused_propagate_weight` less the camera) and
    `resample_fn(key, weights, bank) -> parallel.resample.DistResampleOut`
    replace the single-device passes; `mesh` is the particles mesh whose
    sharded layout the state's bank then has.

    On a CUDA device it raises at construction for a configuration the
    card's kernels do not take (`check_card_limits`)."""

    def __init__(self, camera: Camera, markers_h, marker_mask, config: TrackerConfig,
                 device="cuda", pf_fn=None, resample_fn=None, mesh=None):
        self.config = config
        self.device = torch.device(device)
        if self.device.type == "cuda":
            check_card_limits(config, len(markers_h))
        self.pf_fn = pf_fn
        self.resample_fn = resample_fn
        if mesh is None:
            self.bank = WholeBank()
        else:
            from ..parallel.bank import ShardedBank

            self.bank = ShardedBank(mesh)
        self.camera = camera.to(self.device)
        self.markers_h = torch.as_tensor(markers_h, dtype=torch.float32).to(self.device)
        mask = torch.as_tensor(marker_mask).to(torch.bool)
        self.marker_mask = mask.to(self.device)
        self.n_markers = int(mask.sum())
        m = self.markers_h.shape[0]
        down = list(config.marker_downgrade) + [False] * (m - len(config.marker_downgrade))
        self.downgrade = torch.tensor(down[:m], dtype=torch.bool, device=self.device)
        self._eye4 = torch.eye(4, device=self.device)
        self.dyn = DynamicParams.from_config(config, self.device)
        self._dyn_host = {n: float(_F32(getattr(config, n))) for n in _HOST_DYN}
        self.params = config.blob_params()
        self.host = HostReads()
        self.frames = 0
        self.decoded_frames: list[int] = []
        self.fallback_frames: list[int] = []

    # ------------------------------------------------------------ helpers
    def _t(self, v, dtype=torch.float32) -> torch.Tensor:
        return torch.tensor(v, dtype=dtype, device=self.device)

    def _on_device(self, v) -> torch.Tensor:
        """A caller's number, array or tensor as float32 on the tracker's
        device, with no read back to the host."""
        return torch.as_tensor(v, dtype=torch.float32).to(self.device)

    def _detect(self, image, roi, min_a, max_a, dyn: DynamicParams) -> Detections:
        return find_leds(image, roi, self.params, self.camera, min_a, max_a,
                         threshold=dyn.threshold_value,
                         wh_distortion=dyn.max_width_height_distortion,
                         circ_distortion=dyn.max_circular_distortion, host=self.host)

    def _adaptive_blob_areas(self, dyn: DynamicParams, pred_dist: torch.Tensor):
        c = self.config
        slope = c.blob_area_distance_slope
        min_a = torch.clamp(torch.minimum(dyn.min_blob_area,
                                          dyn.min_blob_area - slope * (pred_dist - 1.0)),
                            min=c.abs_min_blob_area)
        max_a = torch.clamp(torch.minimum(dyn.max_blob_area,
                                          dyn.max_blob_area - slope * (pred_dist - 1.0)),
                            min=c.abs_max_blob_area)
        return min_a, max_a

    def _faults(self, key, det: Detections):
        """The reference's fault injection into a detection bank, and the
        count read again when it ran."""
        c = self.config
        if not (c.number_of_occlusions or c.number_of_false_detections):
            return det, None
        det = inject_faults(key, det, c.number_of_occlusions, c.number_of_false_detections)
        return det, self.host(det.count)

    def _refine_from(self, pose0, det_for_marker, det):
        """Gauss-Newton (plain torch, one pose) from `pose0` on the pairs
        (marker m, detection det_for_marker[m])."""
        c = self.config
        m = self.markers_h.shape[0]
        corr = torch.stack([torch.arange(m, dtype=torch.int32, device=self.device),
                            det_for_marker], -1)
        corr_mask = (det_for_marker >= 0) & self.marker_mask
        return gauss_newton_refine(self.camera, pose0, self.markers_h, det.xy, corr, corr_mask,
                                   c.gn_max_iterations, c.gn_convergence_tol)

    def _update_pose_times(self, state: TargetState, t: torch.Tensor, new_current):
        advance = ((t - state.time_current) > 0.001) | (t < state.time_current)
        return state.replace(
            previous_pose=state.current_pose,
            current_pose=new_current,
            time_previous=torch.where(advance, state.time_current, state.time_previous),
            time_current=torch.where(advance, t, state.time_current),
        )

    def _counters(self, state: TargetState, it, unc, coast, deg) -> TargetState:
        i32 = torch.int32
        return state.replace(it_since_initialized=self._t(it, i32), uncertainty=self._t(unc, i32),
                             coast_frames=self._t(coast, i32), degraded_frames=self._t(deg, i32))

    # ------------------------------------------------------------- step
    def __call__(self, state: TargetState, image: torch.Tensor, t, obs_pose=None, obs_time=None,
                 dyn: DynamicParams | None = None):
        if dyn is None:
            dyn = self.dyn
            dyn_host = self._dyn_host
        else:
            vals = self.host(torch.stack([getattr(dyn, n) for n in _HOST_DYN]))
            dyn_host = dict(zip(_HOST_DYN, vals))
        image = image.to(self.device)
        t = self._on_device(t)
        it, unc, coast, deg = self.host(torch.stack([
            state.it_since_initialized, state.uncertainty, state.coast_frames,
            state.degraded_frames]))
        state = state.replace(fail_flag=self._t(-10, torch.int32),
                              pose_updated=self._t(False, torch.bool))
        counters = (it, unc, coast, deg)
        if it < 1:
            state, det, best_weight, used_bf = self._init_branch(state, image, t, dyn, counters)
        elif self.config.use_particle_filter:
            cam_move_inv = self._eye4
            if self.config.use_cam_pos:
                obs_pose = self._eye4 if obs_pose is None else self._on_device(obs_pose)
                obs_time = self._on_device(0.0 if obs_time is None else obs_time)
                cam_move_inv, state = _ego_motion(state, t, obs_pose, obs_time)
            state, det, best_weight, used_bf = self._track_branch(state, image, t, dyn, dyn_host,
                                                                  counters, cam_move_inv)
        else:
            state, det, best_weight, used_bf = self._ipe_branch(state, image, t, dyn, counters)
        if self.config.use_online_exposure_control:
            exp = exposure_control(
                ExposureState(state.exposure_counter_increase, state.exposure_counter_decrease,
                              state.exposure_us),
                torch.sum(det.area), state.roi[2] * state.roi[3], self.config.expose_time_base,
                det.count > 0)
            state = state.replace(exposure_counter_increase=exp.counter_increase,
                                  exposure_counter_decrease=exp.counter_decrease,
                                  exposure_us=exp.exposure_us)
        self.frames += 1
        result = FrameResult(
            pose=state.current_pose,
            pose_inverse=inverse(state.current_pose),
            covariance=state.covariance,
            pose_updated=state.pose_updated,
            fail_flag=state.fail_flag,
            num_detections=det.count,
            num_gn_iterations=state.num_gn_iterations,
            used_brute_force=self._t(used_bf, torch.bool),
            detections_xy=det.xy,
            detections_mask=det.mask,
            detections_occluded=det.occluded,
            detections_injected=det.injected,
            roi=state.roi,
            best_weight=best_weight,
            blob_area_sum=torch.sum(det.area),
            exposure_us=state.exposure_us,
            resample_clipped=state.resample_clipped,
        )
        return state, result

    # ------------------------------------------------------------- INIT
    def _init_branch(self, state, image, t, dyn, counters):
        c = self.config
        it, unc, coast, deg = counters
        key, k_faults = prng.split(state.key.tolist())
        state = state.replace(key=torch.tensor(key, dtype=torch.int64))
        if c.use_particle_filter and c.pf_init_min_markers > 0:
            init_needed = min(self.n_markers, c.pf_init_min_markers)
        else:
            init_needed = self.n_markers

        growth = float(_F32(c.roi_uncertainty_growth)
                       * (_F32(1.0) + np.floor(_F32(unc) / _F32(3.0))))
        roi = grow_roi(state.roi, growth, growth, self.camera)
        det = self._detect(image, roi, None, None, dyn)
        prev_t = state.current_pose[:3, 3]
        count, prev_norm = self.host(torch.stack([det.count.float(), torch.linalg.norm(prev_t)]))
        had_track = prev_norm > 1e-6
        if count < init_needed and had_track:
            min_a, max_a = self._adaptive_blob_areas(dyn, torch.linalg.norm(prev_t))
            det = self._detect(image, roi, min_a, max_a, dyn)
            count = self.host(det.count)
        det, faulted = self._faults(k_faults, det)
        count = count if faulted is None else faulted
        enough = count >= init_needed

        recently = unc < c.init_consistency_uncertainty_cap
        if enough:
            gate_active = had_track and recently
            prefer = torch.cat([prev_t, self._t([float(gate_active)]),
                                state.current_pose[:3, :3].reshape(9)])
            init_res = initialise(self.camera, det, self.markers_h, self.marker_mask, state.bank,
                                  c, dyn, prefer_near=prefer, fill_seeds=self.bank.fill_seeds)
        else:
            init_res = InitResult(
                success=self._t(False, torch.bool),
                pose=torch.eye(4, device=self.device),
                det_for_marker=torch.full((self.markers_h.shape[0],), -1, dtype=torch.int32,
                                          device=self.device),
                bank=state.bank,
                flag=self._t(int(FailFlag.TOO_FEW_LEDS_INIT), torch.int32),
            )

        if c.init_consistency_radius > 0.0:
            far = torch.linalg.norm(init_res.pose[:3, 3] - prev_t) > c.init_consistency_radius
            if c.init_consistency_rotation_deg > 0.0:
                r_rel = init_res.pose[:3, :3] @ state.current_pose[:3, :3].T
                cos_a = torch.clamp((torch.trace(r_rel) - 1.0) / 2.0, -1.0, 1.0)
                cos_lim = torch.cos(torch.deg2rad(self._t(c.init_consistency_rotation_deg)))
                far = far | (cos_a < cos_lim)
            inconsistent = init_res.success & far & (had_track and recently)
            init_res = init_res._replace(
                success=init_res.success & ~inconsistent,
                flag=torch.where(inconsistent, int(FailFlag.INIT_INCONSISTENT),
                                 init_res.flag).to(torch.int32),
            )

        state = state.replace(roi=roi)
        success, flag = self.host(torch.stack([init_res.success.to(torch.int32), init_res.flag]))
        if success:
            res = self._refine_from(init_res.pose, init_res.det_for_marker, det)
            state = state.replace(
                current_pose=init_res.pose,
                predicted_pose=res.pose,
                covariance=res.covariance,
                bank=init_res.bank,
                resampled=init_res.bank,
                pose_updated=self._t(True, torch.bool),
                num_gn_iterations=res.num_iterations,
                fail_flag=self._t(int(FailFlag.INIT_SUCCESS), torch.int32),
            )
            state = self._counters(state, 1, unc, coast, deg)
            state = self._update_pose_times(state, t, res.pose)
        else:
            bump = 1 if enough else 2
            if flag == int(FailFlag.INIT_INCONSISTENT):
                bump += c.init_consistency_reject_bump
            state = state.replace(pose_updated=self._t(False, torch.bool), fail_flag=init_res.flag)
            state = self._counters(state, it, unc + bump, coast, deg)
        return state, det, self._t(0.0), True

    # ------------------------------------------------------------ TRACK
    def _track_branch(self, state, image, t, dyn, dyn_host, counters, cam_move_inv):
        c = self.config
        it, unc, coast, deg = counters
        key, k_faults, k_resample = prng.split(state.key.tolist(), 3)

        dt_past = state.time_current - state.time_previous
        prediction = predict_constant_velocity(state.previous_pose, state.current_pose, dt_past,
                                               t - state.time_current)
        predicted = cam_move_inv @ (state.current_pose @ prediction)

        # ROI from predicted particle pixels
        s_cap = min(c.roi_particle_subsample, self.bank.n_lanes(state.weights))
        sub = cam_move_inv @ unpack(self.bank.head(state.resampled, s_cap)) @ prediction
        pix = torch.cat([project(self.camera, sub, self.markers_h).reshape(-1, 2),
                         project(self.camera, predicted, self.markers_h)])
        pix_mask = torch.cat([self.marker_mask[None, :].expand(s_cap, -1).reshape(-1),
                              self.marker_mask])
        roi = determine_roi(pix, pix_mask, self.camera, c.roi_border_thickness)
        dist_val = torch.clamp(c.roi_distance_gain / torch.clamp(state.current_pose[2, 3], min=0.1),
                               0.0, 100.0)
        roi = grow_roi(roi, dist_val, dist_val, self.camera)

        min_a, max_a = self._adaptive_blob_areas(dyn, torch.linalg.norm(predicted[:3, 3]))
        det = self._detect(image, roi, min_a, max_a, dyn)
        num_led = self.host(det.count)
        if num_led < c.min_num_leds_detected:
            roi = grow_roi(roi, c.roi_retry_growth, c.roi_retry_growth, self.camera)
            det = self._detect(image, roi, min_a, max_a, dyn)
            num_led = self.host(det.count)
        det, faulted = self._faults(k_faults, det)
        num_led = num_led if faulted is None else faulted

        # PF retry loop
        tracking = it > 1
        # the constant-velocity prediction is trustworthy only on a mature
        # track whose extrapolated step is itself small (the teleport guard
        # in _resample_and_refine reads it)
        pred_trustworthy = self._t(tracking, torch.bool)
        if c.jump_translation_radius > 0.0:
            pred_trustworthy = pred_trustworthy & (
                torch.linalg.norm(prediction[:3, 3]) < 0.5 * c.jump_translation_radius)
        fresh = it == 1
        fac_t, fac_r = propagation_noise_factors(fresh, prediction,
                                                 torch.clamp(t - state.time_current, min=1e-6))
        m_f = _F32(self.n_markers)
        num_led_f = _F32(num_led)
        exit_gate = m_f * min(_F32(dyn_host["pf_exit_gate_factor"]), num_led_f)
        accept_gate = m_f * min(_F32(dyn_host["pf_accept_gate_factor"]), num_led_f)
        noise = NoiseBounds(dyn.min_translation_noise, dyn.max_translation_noise,
                            dyn.min_angular_noise, dyn.max_angular_noise)
        resampled16 = state.resampled

        def pf_compute(pf_it: int, k):
            inflation = float(_F32(1.0) + _F32(dyn_host["noise_inflation_per_10_iters"])
                              * np.floor(_F32(pf_it) / _F32(10.0)))
            apply_pred = tracking and (pf_it % 10 != 0)
            weigh = (self.markers_h, self.marker_mask, det.xy, det.mask,
                     dyn.back_projection_pixel_tolerance_pf, dyn.back_projection_pixel_tolerance,
                     self.downgrade, float(m_f))
            if self.pf_fn is not None:
                return self.pf_fn(k, resampled16, state.current_pose, predicted, prediction,
                                  cam_move_inv, noise, fac_t, fac_r, tracking, apply_pred,
                                  inflation, *weigh)
            skip_propagate, skip_weight = ("propagate" in c.debug_skip,
                                           "weight" in c.debug_skip)
            if c.use_fused_pf_kernel and not (skip_propagate or skip_weight):
                return fused_propagate_weight(
                    k, resampled16, state.current_pose, predicted, prediction, cam_move_inv,
                    noise, fac_t, fac_r, tracking, apply_pred, inflation, self.camera, *weigh,
                    want_pairs=False)
            if skip_propagate:
                # the reference scales by 1 + 1e-12 * inflation, 1 in float32
                bank_i = resampled16
            else:
                bank_i = propagate_soa(k, resampled16, state.current_pose, predicted, prediction,
                                       cam_move_inv, noise, fac_t, fac_r, tracking, apply_pred,
                                       inflation)
            if skip_weight:
                return bank_i, torch.abs(bank_i[..., 0, :]) + 30.0
            weight_fn = weight_particles_bank if c.use_pallas_weight else weight_particles_soa
            return bank_i, weight_fn(self.camera, bank_i, *weigh)[0]

        key, k_loop = prng.split(key)
        state = state.replace(key=torch.tensor(key, dtype=torch.int64))
        k_rest, k0 = prng.split(k_loop)
        bank16, best_w = pf_compute(0, k0)
        highest = self.host(self.bank.max(best_w))
        pf_it = 1
        while pf_it < c.pf_max_retries and highest < exit_gate:
            k_rest, k = prng.split(k_rest)
            bank_i, w_i = pf_compute(pf_it, k)
            new_high = self.host(self.bank.max(w_i))
            if new_high > highest:
                bank16, best_w = bank_i, w_i
            highest = max(highest, new_high)
            pf_it += 1
        highest_t = self.bank.max(best_w)

        if c.motion_prior_radius > 0.0:
            d = torch.linalg.norm(bank16[..., [3, 7, 11], :] - predicted[:3, 3][:, None], dim=-2)
            excess = torch.clamp(d - c.motion_prior_radius, min=0.0) / self._t(
                c.motion_prior_falloff)
            prior = torch.exp(-0.5 * excess * excess)
            small_step = torch.linalg.norm(prediction[:3, 3]) < c.motion_prior_radius
            if tracking:
                best_w = torch.where(small_step, best_w * prior, best_w)
            highest_t = self.bank.max(best_w)

        w_sum, w_sum2 = self.bank.moments(best_w)
        weights_norm = torch.where(w_sum > 0, best_w / torch.clamp(w_sum, min=1e-12), best_w)
        best_idx = self.bank.argmax(best_w)
        n_f = self._t(float(self.bank.n_lanes(best_w)))
        ess_frac = (w_sum * w_sum) / (torch.clamp(w_sum2, min=1e-30) * n_f)
        w_sum_h, highest, ess_h = self.host(torch.stack([w_sum, highest_t, ess_frac]))
        accepted = w_sum_h > 0 and highest > accept_gate
        marginal = highest < accept_gate + _F32(dyn_host["marginal_margin_factor"]) * num_led_f

        state = state.replace(bank=bank16, roi=roi)
        if accepted:
            flag = int(FailFlag.PF_SUCCESS)
            coast = 0
            state = state.replace(pose_updated=self._t(False, torch.bool))
            if marginal:
                if unc < c.uncertainty_cap:
                    unc += 1
                    pose_b = self.bank.pick_lane(bank16, best_idx).reshape(4, 4)
                    _, p_b, nc_b = weight_particles(
                        self.camera, pose_b[None], self.markers_h, self.marker_mask, det.xy,
                        det.mask, dyn.back_projection_pixel_tolerance_pf,
                        dyn.back_projection_pixel_tolerance, self.downgrade, self._t(float(m_f)))
                    if self.host(nc_b[0]) == 3:
                        p = p_b[0]
                        three = p[argsort_stable((p[:, 0] < 0).to(torch.int32))][:3]
                        res = short_p3p(self.camera, det, self.markers_h, self.marker_mask, three,
                                        bank16, c, dyn, fill_seeds=self.bank.fill_seeds)
                        if self.host(res.success):
                            state = state.replace(bank=res.bank)
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
                    deg = 0
                    it = 0
                    unc = max(c.init_consistency_uncertainty_cap
                              - c.init_consistency_reject_bump - 1, 0)
                    flag = int(FailFlag.UNCERTAINTY_REINIT)
            state = state.replace(fail_flag=self._t(flag, torch.int32))
            if it > 0:
                state, jump = self._resample_and_refine(state, k_resample, det, state.bank,
                                                        weights_norm, dyn, t, ess_h, best_idx,
                                                        predicted, pred_trustworthy)
                it = min(it + 1, 2)
                state = state.replace(fail_flag=torch.where(
                    jump, int(FailFlag.PF_JUMP), state.fail_flag).to(torch.int32))
        else:
            coast_ok = c.pf_coast_frames > 0 and it >= 2 and coast < c.pf_coast_frames
            unc += 1
            it = it if coast_ok else 0
            coast = coast + 1 if coast_ok else 0
            state = state.replace(
                fail_flag=self._t(int(FailFlag.PF_NO_REASONABLE_PARTICLE), torch.int32),
                predicted_pose=self.bank.pick_lane(bank16, best_idx).reshape(4, 4),
                pose_updated=self._t(False, torch.bool),
                weights=weights_norm,
            )
        state = self._counters(state, it, unc, coast, deg)
        return state, det, highest_t, False

    # -------------------------------------------------------- IPE TRACK
    def _ipe_branch(self, state, image, t, dyn, counters):
        """The track branch without a particle filter (reference
        `ipe_track_branch`): nearest-neighbour correspondences from the
        predicted pose, checked by P3P consensus, then Gauss-Newton; the
        brute-force initialisation when the check fails."""
        c = self.config
        it, unc, coast, deg = counters
        key, k_faults = prng.split(state.key.tolist())
        state = state.replace(key=torch.tensor(key, dtype=torch.int64))
        min_a, _ = self._adaptive_blob_areas(dyn, torch.linalg.norm(state.predicted_pose[:3, 3]))

        # const-velocity prediction once the track is mature, else the last prediction
        if it >= 2:
            dt_past = state.time_current - state.time_previous
            predicted = state.current_pose @ predict_constant_velocity(
                state.previous_pose, state.current_pose, dt_past, t - state.time_current)
            state = state.replace(predicted_pose=predicted)
        pix = project(self.camera, state.predicted_pose, self.markers_h)
        roi = determine_roi(pix, self.marker_mask, self.camera, c.roi_border_thickness)
        det = self._detect(image, roi, min_a, None, dyn)
        count = self.host(det.count)
        if count < c.min_num_leds_detected:  # search the whole frame once
            roi = self._t([0.0, 0.0, float(self.camera.width), float(self.camera.height)])
            det = self._detect(image, roi, min_a, None, dyn)
            count = self.host(det.count)
        det, faulted = self._faults(k_faults, det)
        count = count if faulted is None else faulted
        state = state.replace(roi=roi)
        if count < c.min_num_leds_detected:
            state = state.replace(
                fail_flag=self._t(int(FailFlag.TOO_FEW_MARKERS_DETECTED), torch.int32))
            return state, det, self._t(0.0), False

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
            init_res = initialise(self.camera, det, self.markers_h, self.marker_mask, state.bank,
                                  c, dyn, fill_seeds=self.bank.fill_seeds)
            if not self.host(init_res.success):
                state = state.replace(fail_flag=init_res.flag)
                return self._counters(state, 0, unc, coast, deg), det, self._t(0.0), False
            res = self._refine_from(init_res.pose, init_res.det_for_marker, det)
            state = state.replace(current_pose=init_res.pose)
            flag = FailFlag.INIT_SUCCESS
        state = state.replace(
            predicted_pose=res.pose,
            covariance=res.covariance,
            pose_updated=self._t(True, torch.bool),
            num_gn_iterations=res.num_iterations,
            fail_flag=self._t(int(flag), torch.int32),
        )
        state = self._counters(state, min(it + 1, 2), unc, coast, deg)
        return self._update_pose_times(state, t, res.pose), det, self._t(0.0), False

    def _resample_and_refine(self, state, key, det, bank16, weights_norm, dyn, t, ess_h,
                             argmax_idx, predicted, pred_trustworthy):
        """Resampling (ESS-gated) + GN refinement over 2M+1 binding
        hypotheses of the most-resampled particle; with a
        `jump_translation_radius`, a GN pose farther than it from the
        trustworthy prediction publishes the prediction and sets the jump
        flag."""
        c = self.config
        dev = self.device
        if "resample" in c.debug_skip:
            resampled16, most = bank16, self.bank.argmax(weights_norm)
        elif c.resample_min_ess <= 0.0 or ess_h < c.resample_min_ess:
            if self.resample_fn is not None:
                out = self.resample_fn(key, weights_norm, bank16)
                resampled16, most = out.resampled, out.most
                state = state.replace(resample_clipped=state.resample_clipped
                                      + out.clipped.to(torch.int32))
            elif c.use_pallas_resample:
                resampled16, most, decoded = resample_bank(key, weights_norm, bank16,
                                                           _sort_resample, self.host)
                (self.decoded_frames if decoded else self.fallback_frames).append(self.frames)
            else:
                resample = (stratified_resample_closed if c.use_closed_form_resample
                            else stratified_resample_soa)
                anc, _counts, most = resample(key, weights_norm)
                resampled16 = resample_gather(bank16, anc)
        else:
            resampled16, most = bank16, argmax_idx

        pre_gn = self.bank.pick_lane(bank16, most).reshape(4, 4)
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
        if c.use_pallas_gn:
            res = gauss_newton_refine_batched(self.camera, poses0, self.markers_h, det.xy, dfm_h,
                                              corr_masks, c.gn_max_iterations,
                                              c.gn_convergence_tol)
        else:
            corrs = torch.stack([marker_ids[None, :].expand(n_h, m_cap).to(dfm_h.dtype), dfm_h],
                                dim=-1)
            res = gauss_newton_refine(self.camera, poses0, self.markers_h, det.xy, corrs,
                                      corr_masks, c.gn_max_iterations, c.gn_convergence_tol)
        n_pairs = torch.sum(corr_masks, dim=-1).float()
        local = torch.linalg.norm(res.pose[:, :3, 3] - pre_gn[:3, 3][None], dim=-1) <= c.gn_step_radius
        feasible = (res.max_residual <= c.gn_residual_gate) & (n_pairs > 0) & local
        pref = n_pairs - 1e-3 * torch.arange(n_h, dtype=torch.float32, device=dev)
        pref = torch.where(feasible, pref, torch.full((), float("-inf"), device=dev))
        any_feasible = torch.any(feasible)
        best_h = torch.where(any_feasible, torch.argmax(pref), torch.zeros((), dtype=torch.int64,
                                                                          device=dev))
        pick = lambda x: x.index_select(0, best_h.reshape(1))[0]
        pose = torch.where(any_feasible, pick(res.pose), pre_gn)
        jump = torch.max(torch.abs(pose[:3, :3] - pre_gn[:3, :3])) >= dyn.jump_threshold
        final_pose = pose
        if c.jump_translation_radius > 0.0:
            teleport = pred_trustworthy & (torch.linalg.norm(pose[:3, 3] - predicted[:3, 3])
                                           > c.jump_translation_radius)
            final_pose = torch.where(teleport, predicted, pose)
            jump = jump | teleport
        state = state.replace(
            predicted_pose=final_pose,
            covariance=pick(res.covariance),
            pose_updated=self._t(True, torch.bool),
            num_gn_iterations=pick(res.num_iterations),
            resampled=resampled16,
            weights=weights_norm,
            bank=bank16,
        )
        return self._update_pose_times(state, t, final_pose), jump


def _sort_resample(key, weights, bank16):
    """The sort path with kernel C: `resample_bank`'s fallback."""
    anc, _counts, most = stratified_resample_soa(key, weights)
    return resample_gather(bank16, anc), most


def make_tracker(camera: Camera, markers_h, marker_mask, config: TrackerConfig,
                 device="cuda", pf_fn=None, resample_fn=None, mesh=None) -> Tracker:
    """Build the per-frame step for one target on `device` (the card unless
    asked otherwise); the hooks and the mesh as `Tracker` takes them."""
    return Tracker(camera, markers_h, marker_mask, config, device, pf_fn, resample_fn, mesh)


_STEP_CACHE: dict = {}
_STEP_CACHE_SIZE = 8


def _value_key(x) -> tuple:
    """A hashable key of a tensor's or array's dtype, shape and bytes."""
    a = np.ascontiguousarray(torch.as_tensor(x).detach().cpu().numpy())
    return (str(a.dtype), a.shape, a.tobytes())


def tracker_step(state: TargetState, image: torch.Tensor, t, camera: Camera, markers_h,
                 marker_mask, config: TrackerConfig, obs_pose=None, obs_time=None, dyn=None,
                 resample_fn=None, pf_fn=None, wrap_replicated=None):
    """Advance one target by one frame -> (state', FrameResult): the
    reference's functional `tracker_step`, as a thin wrapper over `Tracker`.

    It keeps one `Tracker` per (camera, markers, mask, config) and device in
    a small cache (the oldest of 8 goes first; the key reads the camera and
    markers on the host) and runs on the device that `state` lives on.  The
    reference's SPMD hooks `resample_fn`, `pf_fn` and `wrap_replicated`,
    which its `parallel/mesh.py` sets, have `parallel.make_sharded_tracker`
    as their counterpart here: they must be None."""
    given = [name for name, hook in (("resample_fn", resample_fn), ("pf_fn", pf_fn),
                                     ("wrap_replicated", wrap_replicated)) if hook is not None]
    if given:
        raise TypeError(f"tracker_step: {', '.join(given)} are the reference's SPMD hooks; "
                        "build a sharded step with parallel.make_sharded_tracker instead")
    device = state.bank.device
    cam = (camera.fx, camera.fy, camera.cx, camera.cy, camera.dist)
    key = (tuple(_value_key(v) for v in cam), camera.width, camera.height,
           _value_key(markers_h), _value_key(marker_mask), config, str(device))
    step = _STEP_CACHE.get(key)
    if step is None:
        if len(_STEP_CACHE) >= _STEP_CACHE_SIZE:
            _STEP_CACHE.pop(next(iter(_STEP_CACHE)))
        step = _STEP_CACHE[key] = Tracker(camera, markers_h, marker_mask, config, device)
    return step(state, image, t, obs_pose, obs_time, dyn)

