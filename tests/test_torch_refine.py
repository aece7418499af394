"""Gauss-Newton refinement: kernel D's plain version against
`gauss_newton_refine_pallas` in interpret mode (11 = 2M + 1 hypotheses,
as the track branch builds them), and the single-pose refiner of the init
branch against the reference's `gauss_newton_refine`.  Sums over the
pairs may run in another order on the two sides, so poses agree to 1e-5
and residuals to 1e-3 px."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pf_monocular_pose_estimator_tpu.geometry.camera import Camera as RefCamera
from pf_monocular_pose_estimator_tpu.geometry.camera import project as ref_project
from pf_monocular_pose_estimator_tpu.geometry.se3 import exp_se3 as ref_exp
from pf_monocular_pose_estimator_tpu.pf.pallas_refine import gauss_newton_refine_pallas
from pf_monocular_pose_estimator_tpu.pf.refine import gauss_newton_refine as ref_gn
from pf_monocular_pose_estimator_tpu.pf.refine import inv6_spd as ref_inv6
from pf_monocular_pose_estimator_tpu.pf.refine import solve6_spd as ref_solve6
from pf_monocular_pose_estimator_tpu_torch.geometry import Camera
from pf_monocular_pose_estimator_tpu_torch.pf import refine, refine_kernel

torch.set_num_threads(2)

CAM = dict(fx=420.0, fy=418.0, cx=376.0, cy=240.0)


def _problem(seed, b=11):
    rng = np.random.default_rng(seed)
    markers = np.concatenate([rng.normal(0, 0.08, (5, 3)), np.ones((5, 1))], 1).astype(np.float32)
    gt = np.asarray(ref_exp(jnp.asarray([0.02, -0.01, 1.5, 0.1, -0.05, 0.3], jnp.float32)))
    det = np.zeros((16, 2), np.float32)
    det[:5] = np.asarray(ref_project(RefCamera.create(**CAM), jnp.asarray(gt), jnp.asarray(markers)))
    det[:5] += rng.normal(0, 0.3, (5, 2)).astype(np.float32)
    det[5] = det[2] + 3.0  # a clone: the swap hypothesis binds it
    poses0 = np.asarray(jax.vmap(lambda t: ref_exp(t) @ gt)(
        jnp.asarray(rng.normal(size=(b, 6)) * 0.02, jnp.float32)))
    dfm = np.tile(np.arange(5, dtype=np.int32), (b, 1))
    dfm[1, 2] = 5
    for h in range(6, b):
        dfm[h, h - 6] = -1
    mask = dfm >= 0
    return markers, det, poses0, dfm, mask


def test_batched_gn_matches_pallas():
    markers, det, poses0, dfm, mask = _problem(0)
    want = gauss_newton_refine_pallas(RefCamera.create(**CAM), jnp.asarray(poses0),
                                      jnp.asarray(markers), jnp.asarray(det), jnp.asarray(dfm),
                                      jnp.asarray(mask), 25, 1e-4, interpret=True)
    got = refine_kernel.gauss_newton_refine_batched(
        Camera.create(**CAM), torch.from_numpy(poses0), torch.from_numpy(markers),
        torch.from_numpy(det), torch.from_numpy(dfm), torch.from_numpy(mask), 25, 1e-4)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.num_iterations.numpy(), np.asarray(want.num_iterations))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    np.testing.assert_allclose(got.max_residual.numpy(), np.asarray(want.max_residual), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got.final_error.numpy(), np.asarray(want.final_error), rtol=1e-3,
                               atol=1e-4)
    # covariance = inverse of the final normal matrix: the bar tests/test_pf.py uses
    np.testing.assert_allclose(got.covariance.numpy(), np.asarray(want.covariance), rtol=1e-2,
                               atol=1e-4)
    assert float(got.max_residual.numpy()[0]) < 1.5  # the clean binding converged


def test_single_pose_gn_matches_reference():
    markers, det, poses0, dfm, mask = _problem(1)
    corr = np.stack([np.arange(5, dtype=np.int32), dfm[0]], -1)
    want = ref_gn(RefCamera.create(**CAM), jnp.asarray(poses0[3]), jnp.asarray(markers),
                  jnp.asarray(det), jnp.asarray(corr), jnp.asarray(mask[0]), 25, 1e-4)
    got = refine.gauss_newton_refine(Camera.create(**CAM), torch.from_numpy(poses0[3]),
                                     torch.from_numpy(markers), torch.from_numpy(det),
                                     torch.from_numpy(corr), torch.from_numpy(mask[0]), 25, 1e-4)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), rtol=0, atol=1e-5)
    assert int(got.num_iterations) == int(want.num_iterations)
    np.testing.assert_allclose(got.covariance.numpy(), np.asarray(want.covariance), rtol=1e-2,
                               atol=1e-6)


def test_solve6_and_inv6_match_reference():
    rng = np.random.default_rng(2)
    j = rng.normal(size=(4, 10, 6)).astype(np.float32)
    a = np.einsum("bki,bkj->bij", j, j) + 1e-3 * np.eye(6, dtype=np.float32)
    b = rng.normal(size=(4, 6)).astype(np.float32)
    for refine_step in (False, True):
        np.testing.assert_allclose(
            refine.solve6_spd(torch.from_numpy(a), torch.from_numpy(b), refine_step).numpy(),
            np.asarray(ref_solve6(jnp.asarray(a), jnp.asarray(b), refine_step)), rtol=1e-4,
            atol=1e-5)
    np.testing.assert_allclose(refine.inv6_spd(torch.from_numpy(a)).numpy(),
                               np.asarray(ref_inv6(jnp.asarray(a))), rtol=1e-4, atol=1e-5)
