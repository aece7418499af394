"""The tracker's `pf_fn` hook over a particles mesh (port of
`parallel/pf_kernels.py`): one propagate + weight pass, each shard on its
own (16, S) block.

Propagation and weighting are independent per particle.  Two things make
the sharded pass equal the whole-bank pass bit for bit: the threefry draws
are a counter hash of the global particle index, so a shard passes
`lane_offset = shard * S` and `n_total = N` and computes exactly its slice
of the global draw stream; and the candidate lanes 0 / 1 (current and
predicted pose) are pinned by global lane, so only the shard that holds
them writes them.

The reference's `replicated()` has no counterpart: detection and
Gauss-Newton take replicated operands and simply run whole on every rank.
"""

from __future__ import annotations

import torch

from ..pf.soa import propagate_soa, weight_particles_soa
from ..pf.step_kernel import pf_step, step_params
from ..pf.weight_kernel import weight_particles_bank


def make_sharded_pf_fn(mesh, camera, config):
    """Build `pf_fn(key, resampled16, current_pose, predicted, prediction,
    cam_move_inv, noise, fac_t, fac_r, tracking, apply_pred, inflation,
    markers_h, marker_mask, det_xy, det_mask, tol_pf, tol_init, downgrade,
    num_markers_score) -> (bank16 (L, 16, S), weights (L, S))` for a bank in
    the mesh's sharded layout.

    With `use_fused_pf_kernel` each shard runs kernel B (`pf_step`) on its
    block, from one parameter vector built once a pass; without it each
    shard runs the torch-op propagation and kernel E (`use_pallas_weight`)
    or the torch-op weight."""
    n = config.n_particles
    if n % mesh.size:
        raise ValueError(f"n_particles={n} must divide over {mesh.size} shards")
    s = n // mesh.size

    def fused(key, resampled16, current_pose, predicted, prediction, cam_move_inv, noise, fac_t,
              fac_r, tracking, apply_pred, inflation, markers_h, marker_mask, det_xy, det_mask,
              tol_pf, tol_init, downgrade, num_markers_score):
        prm, keys4 = step_params(key, current_pose, predicted, prediction, cam_move_inv, noise,
                                 fac_t, fac_r, tracking, apply_pred, inflation, camera, markers_h,
                                 marker_mask, det_xy, det_mask, tol_pf, tol_init, downgrade,
                                 num_markers_score)
        outs = [pf_step(resampled16[i], prm, keys4, markers_h.shape[0], det_xy.shape[0], r * s, n)
                for i, r in enumerate(mesh.ranks)]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])

    def unfused(key, resampled16, current_pose, predicted, prediction, cam_move_inv, noise,
                fac_t, fac_r, tracking, apply_pred, inflation, *weigh):
        weight_fn = weight_particles_bank if config.use_pallas_weight else weight_particles_soa
        banks = [propagate_soa(key, resampled16[i], current_pose, predicted, prediction,
                               cam_move_inv, noise, fac_t, fac_r, tracking, apply_pred, inflation,
                               r * s, n)
                 for i, r in enumerate(mesh.ranks)]
        return torch.stack(banks), torch.stack([weight_fn(camera, b, *weigh)[0] for b in banks])

    return fused if config.use_fused_pf_kernel else unfused
