"""The plain twins of kernels B, E and D beyond the tracker's default
shapes -- K = 32 detection slots and M = 12 markers, which run the wide
forms on the card -- against the reference's Pallas kernels in interpret
mode.  The card holds each kernel to its plain twin at these shapes and
the rest of the grid (`tests/test_torch_kernels_cuda.py`, chip_smoke.py's
[shapes] phase).

Tolerances as in tests/test_torch_weight.py and test_torch_pf_step.py:
pairs and pair counts are integers and must be equal; XLA on the CPU
contracts some multiply-adds into FMAs where the port rounds every
product, so banks agree to float32 ulps (rtol 2e-6, atol 2e-7) and weights
to 1e-4 (1e-6 relative where they reach 1e36).  GN as in
tests/test_torch_refine.py (`_check_batched_gn`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf_monocular_pose_estimator_tpu.geometry.camera import Camera as RefCamera
from pf_monocular_pose_estimator_tpu.pf.pallas_step import fused_propagate_weight_pallas
from pf_monocular_pose_estimator_tpu.pf.pallas_weight import weight_particles_pallas
from pf_monocular_pose_estimator_tpu.pf.propagate import NoiseBounds as RefNoise
from pf_monocular_pose_estimator_tpu_torch.geometry import Camera
from pf_monocular_pose_estimator_tpu_torch.pf import step_kernel, weight_kernel
from pf_monocular_pose_estimator_tpu_torch.pf.propagate import NoiseBounds
from test_torch_kernels_cuda import GREEDY_CAM, GREEDY_CASES, greedy_edge_lanes, shape_lanes
from test_torch_pf_step import _pose
from test_torch_refine import _check_batched_gn, _problem

torch.set_num_threads(2)

M, K = 12, 32
ORDER = ("markers_h", "marker_mask", "det_xy", "det_mask", "tol_pf", "tol_init", "downgrade")
NOISE = dict(min_translation=-0.01, max_translation=0.01, min_angular=-0.02, max_angular=0.02)
t = lambda a: torch.from_numpy(np.array(a))


def _check_weight(bank, a):
    want = weight_particles_pallas(RefCamera.create(**GREEDY_CAM), jnp.asarray(bank),
                                   *(jnp.asarray(a[n]) for n in ORDER), None, block=512,
                                   interpret=True)
    got = weight_kernel.weight_particles_bank(Camera.create(**GREEDY_CAM), t(bank),
                                              *(torch.as_tensor(a[n]) for n in ORDER))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-4)
    return got[2].numpy()


def test_weight_plain_wide_matches_pallas():
    """Kernel E's plain version at K = 32, M = 12 (`shape_lanes`: ties
    across and within rows, masked padding on exact projections, a masked
    marker, NaN and inf lanes) against the Pallas kernel."""
    n_corr = _check_weight(*shape_lanes(M, K, 517)[:2])
    assert n_corr.max() >= M - 1


@pytest.mark.parametrize("case", GREEDY_CASES)
def test_weight_plain_wide_edge_cases_match_pallas(case):
    """The same on `greedy_edge_lanes` at K = 32, M = 12."""
    bank, a, _ = greedy_edge_lanes(case, M, K, 517)
    n_corr = _check_weight(bank, a)
    assert (n_corr[np.isnan(bank[:12]).any(0)] == 0).all()


@pytest.mark.parametrize("folded", [True, False])
def test_pf_step_plain_wide_matches_pallas(folded):
    """Kernel B's plain version at K = 32, M = 12 against the folded Pallas
    kernel (weights) and the straight one (with pairs)."""
    bank, a, _ = shape_lanes(M, K, 1024, seed=3)
    bank = np.nan_to_num(bank, nan=0.5, posinf=0.5)  # the XLA compose would spread NaN rows
    rng = np.random.default_rng(4)
    poses = [_pose(rng, 0.3), _pose(rng, 0.3), _pose(rng, 0.01, 0.0), _pose(rng, 0.01, 0.0)]
    fac_t, fac_r = np.float32([0.3] * 3), np.float32([0.2] * 3)
    key = jax.random.PRNGKey(5)
    want = fused_propagate_weight_pallas(
        key, jnp.asarray(bank), *(jnp.asarray(p) for p in poses), RefNoise(**NOISE),
        jnp.asarray(fac_t), jnp.asarray(fac_r), True, True, jnp.float32(1.025),
        RefCamera.create(**GREEDY_CAM), *(jnp.asarray(a[n]) for n in ORDER), None, block=512,
        interpret=True, want_pairs=not folded, folded=folded)
    got = step_kernel.fused_propagate_weight(
        tuple(np.asarray(key).tolist()), t(bank), *(t(p) for p in poses), NoiseBounds(**NOISE),
        t(fac_t), t(fac_r), True, True, 1.025, Camera.create(**GREEDY_CAM),
        *(torch.as_tensor(a[n]) for n in ORDER), want_pairs=not folded)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=2e-6, atol=2e-7)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-4)
    if not folded:
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        assert np.asarray(want[3]).max() >= M - 1


def test_gn_plain_wide_matches_pallas():
    """Kernel D's plain version at M = 12 (2M + 1 = 25 hypotheses, as the
    track branch builds them) against the Pallas kernel."""
    _check_batched_gn(*_problem(0, 2 * M + 1, M))
