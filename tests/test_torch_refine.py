"""Gauss-Newton refinement: kernel D's plain version against
`gauss_newton_refine_pallas` in interpret mode (11 = 2M + 1 hypotheses,
as the track branch builds them), and the single-pose refiner of the init
branch against the reference's `gauss_newton_refine`.  Sums over the
pairs may run in another order on the two sides, so poses agree to 1e-5
and residuals to 1e-3 px.  The fused refine's plain twin
(`refine_frame_plain`) against the layer op by op, to the bit."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import refine_cases
import torch

from pf_monocular_pose_estimator_tpu.geometry.camera import Camera as RefCamera
from pf_monocular_pose_estimator_tpu.geometry.camera import project as ref_project
from pf_monocular_pose_estimator_tpu.geometry.se3 import exp_se3 as ref_exp
from pf_monocular_pose_estimator_tpu.pf.pallas_refine import gauss_newton_refine_pallas
from pf_monocular_pose_estimator_tpu.pf.refine import gauss_newton_refine as ref_gn
from pf_monocular_pose_estimator_tpu.pf.refine import inv6_spd as ref_inv6
from pf_monocular_pose_estimator_tpu.pf.refine import solve6_spd as ref_solve6
from pf_monocular_pose_estimator_tpu_torch.geometry import Camera
import pf_monocular_pose_estimator_tpu_torch.tracker.step as port_step
from pf_monocular_pose_estimator_tpu_torch.ops.blob import Detections
from pf_monocular_pose_estimator_tpu_torch.pf import refine, refine_kernel
from pf_monocular_pose_estimator_tpu_torch.tracker import TargetState, make_tracker
from pf_monocular_pose_estimator_tpu_torch.tracker.step import refine_hypotheses
from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig
from pf_monocular_pose_estimator_tpu_torch.utils.prng import prng_key

torch.set_num_threads(2)

CAM = dict(fx=420.0, fy=418.0, cx=376.0, cy=240.0)
GT = [0.02, -0.01, 1.5, 0.1, -0.05, 0.3]  # twist of the true pose


def _problem(seed, b=11, m=5):
    rng = np.random.default_rng(seed)
    markers = np.concatenate([rng.normal(0, 0.08, (m, 3)), np.ones((m, 1))], 1).astype(np.float32)
    gt = np.asarray(ref_exp(jnp.asarray(GT, jnp.float32)))
    det = np.zeros((16, 2), np.float32)
    det[:m] = np.asarray(ref_project(RefCamera.create(**CAM), jnp.asarray(gt), jnp.asarray(markers)))
    det[:m] += rng.normal(0, 0.3, (m, 2)).astype(np.float32)
    det[m] = det[2] + 3.0  # a clone: the swap hypothesis binds it
    poses0 = np.asarray(jax.vmap(lambda t: ref_exp(t) @ gt)(
        jnp.asarray(rng.normal(size=(b, 6)) * 0.02, jnp.float32)))
    dfm = np.tile(np.arange(m, dtype=np.int32), (b, 1))
    dfm[1, 2] = m
    for h in range(m + 1, b):
        dfm[h, h - m - 1] = -1
    mask = dfm >= 0
    return markers, det, poses0, dfm, mask


def _check_batched_gn(markers, det, poses0, dfm, mask, diverged=()):
    """The plain twin (through `gauss_newton_refine_batched`) against the
    Pallas kernel.  A diverged hypothesis reverts to its start pose and
    error on both sides; its residual and normal matrix are those of the
    unreverted last pose, which a run far from any minimum reaches along a
    path where ulps grow, so those two are compared on the other rows."""
    want = gauss_newton_refine_pallas(RefCamera.create(**CAM), jnp.asarray(poses0),
                                      jnp.asarray(markers), jnp.asarray(det), jnp.asarray(dfm),
                                      jnp.asarray(mask), 25, 1e-4, interpret=True)
    got = refine_kernel.gauss_newton_refine_batched(
        Camera.create(**CAM), torch.from_numpy(poses0), torch.from_numpy(markers),
        torch.from_numpy(det), torch.from_numpy(dfm), torch.from_numpy(mask), 25, 1e-4)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.num_iterations.numpy(), np.asarray(want.num_iterations))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    np.testing.assert_allclose(got.final_error.numpy(), np.asarray(want.final_error), rtol=1e-3,
                               atol=1e-4)
    for i in diverged:
        np.testing.assert_array_equal(got.pose.numpy()[i], poses0[i])
        np.testing.assert_array_equal(np.asarray(want.pose)[i], poses0[i])
        assert float(got.final_error[i]) == float(got.initial_error[i])
    keep = np.setdiff1d(np.arange(len(poses0)), diverged)
    np.testing.assert_allclose(got.max_residual.numpy()[keep], np.asarray(want.max_residual)[keep],
                               rtol=0, atol=1e-3)
    # covariance = inverse of the final normal matrix: the bar tests/test_pf.py uses
    np.testing.assert_allclose(got.covariance.numpy()[keep], np.asarray(want.covariance)[keep],
                               rtol=1e-2, atol=1e-4)
    assert float(got.max_residual.numpy()[0]) < 1.5  # the clean binding converged


def test_batched_gn_matches_pallas():
    _check_batched_gn(*_problem(0))


@pytest.mark.parametrize("m", [3, 8])
def test_batched_gn_matches_pallas_diverging(m):
    """2M + 1 hypotheses at M = 3 and M = 8; the last binds every marker but
    starts 3 m further along the optical axis, from where GN ends with a
    larger error than it began with, and reverts.  The plain twin (what
    kernel D is held to on the card) follows the Pallas kernel there too."""
    markers, det, poses0, dfm, mask = _problem(0, 2 * m + 1, m)
    poses0 = poses0.copy()
    far = np.asarray(ref_exp(jnp.asarray([0.0, 0.0, 3.0, 0.0, 0.0, 0.0], jnp.float32)))
    poses0[-1] = far @ np.asarray(ref_exp(jnp.asarray(GT, jnp.float32)))
    dfm[-1] = np.arange(m)
    if m < 4:  # two markers leave the six unknowns underdetermined: bind all three
        dfm[m + 1:] = np.arange(m)
    _check_batched_gn(markers, det, poses0, dfm, dfm >= 0, diverged=(2 * m,))


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


def _same(got, want):
    """Equal to the bit; NaN where the other has NaN (a covariance of a
    binding with too few pairs to fix the pose)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def _check_fused_twin(p):
    """`refine_frame_plain` against the layer op by op with kernel D's plain
    twin (`refine_hypotheses(..., batched=True)`, the parent's default): the
    published pose, its covariance, the iterations and the jump flag equal
    to the bit.  The twin's translation norms are written out where the
    chain calls `torch.linalg.norm`; they differ by an ulp at most, which
    moves a pick or the guard only on the boundary of its radius."""
    got = refine_kernel.refine_frame_plain(*refine_cases.fused_args(p))
    want = refine_hypotheses(*refine_cases.chain_args(p), batched=True)
    for g, w in zip(got[:4], want):
        _same(g, w)
    return got


@pytest.mark.parametrize("m", [1, 3, 5, 9])
@pytest.mark.parametrize("case", refine_cases.CASES)
def test_refine_frame_plain_matches_chain(case, m):
    """Every case of `tests/refine_cases.py` at K = 16, 2M + 1 hypotheses."""
    p = refine_cases.frame_case(case, m, 16)
    got = _check_fused_twin(p)
    best, any_feasible, teleported = (int(x) for x in got.info[1:])
    if case in ("clean", "tie") and m >= 3:
        assert any_feasible
    if case == "infeasible":  # falls back to the picked particle
        assert best == 0 and not any_feasible and torch.equal(got.pose, p["pre_gn"])
    if m >= 3:  # one pair barely turns the pose
        assert bool(got.jump) == (case == "guard_trusted" or (case == "jump" and any_feasible))
    assert teleported == (case == "guard_trusted")


@pytest.mark.parametrize("m,k,hypotheses", [(3, 1, 4), (5, 1, 1), (5, 16, 1), (8, 16, 4),
                                            (16, 128, 4)])
def test_refine_frame_plain_matches_chain_shapes(m, k, hypotheses):
    """One detection slot, the base binding alone, and the widest marker and
    slot counts a tracker on the card takes below the kernel's limits."""
    for case in ("clean", "tie", "occluded"):
        _check_fused_twin(refine_cases.frame_case(case, m, k, hypotheses=hypotheses))


def test_refine_frame_plain_matches_chain_on_golden_frames(monkeypatch):
    """The tracker on the golden sequence (2,000 particles, the CPU twins):
    each tracked frame's refine inputs through both, equal to the bit, and
    the fused wrapper called once a tracked frame without a launch."""
    d = np.load(os.path.join(os.path.dirname(__file__), "golden", "golden_sequence.npz"))
    cam = Camera.create(float(d["fx"]), float(d["fy"]), float(d["cx"]), float(d["cy"]),
                        np.asarray(d["dist"], np.float32), int(d["width"]), int(d["height"]))
    markers = np.concatenate([d["markers"], np.ones((5, 1), np.float32)], 1)
    step = make_tracker(cam, torch.from_numpy(markers), torch.ones(5, dtype=torch.bool),
                        TrackerConfig(n_particles=2000, min_blob_area=8.0, pf_max_retries=8,
                                      roi_particle_subsample=128), device="cpu")
    real, seen = port_step.refine_frame, []

    def both(*args):
        got = real(*args)
        scal, pre_gn, mark, marker_mask, det_xy, det_mask, _, jump_thr, predicted, trust = args[:10]
        det = Detections(xy=det_xy, xy_distorted=det_xy, mask=det_mask, area=det_xy[:, 0],
                         occluded=det_mask, injected=det_mask)
        want = refine_hypotheses(step.camera, pre_gn, step.markers_h, marker_mask, step.downgrade,
                                 det, step.dyn, predicted, trust, step.config, batched=True)
        for g, w in zip(got[:4], want):
            _same(g, w)
        seen.append(int(got.info[1]))
        return got

    monkeypatch.setattr(port_step, "refine_frame", both)
    calls, launches = refine_kernel.refine_frame.calls, refine_kernel.refine_frame.launches
    state = TargetState.create(2000, prng_key(0), device="cpu")
    for i in range(4):
        state, _ = step(state, torch.from_numpy(d["frames"][i]), float(d["times"][i]))
    assert len(seen) == 3  # the init frame refines through its own branch
    assert refine_kernel.refine_frame.calls - calls == 3
    assert refine_kernel.refine_frame.launches == launches


def _pose_args(case, m, k=16):
    """`refine_pose`'s arguments from problem p of `tests/refine_cases.py`:
    the picked particle's pose and its greedy pairs (the base binding)."""
    p = refine_cases.frame_case(case, m, k)
    args = refine_cases.fused_args(p)
    dfm = refine_kernel.frame_hypotheses(*args[:7], False)[0].to(torch.int32)
    return p, (args[0], p["pre_gn"], args[2], p["marker_mask"], dfm, p["det"].xy)


@pytest.mark.parametrize("m", [1, 3, 5, 9])
@pytest.mark.parametrize("case", ["clean", "tie", "occluded"])
def test_refine_pose_plain_is_gauss_newton_refine(case, m):
    """The one-pose refine on the CPU (its plain twin) against the port's
    `gauss_newton_refine` on the same pose and pairs, to the bit: the twin is
    that function, whose arithmetic the card's kernel repeats.  One call, no
    launch."""
    p, args = _pose_args(case, m)
    calls, launches = refine_kernel.refine_pose.calls, refine_kernel.refine_pose.launches
    got = refine_kernel.refine_pose(*args, 25, 1e-4)
    assert refine_kernel.refine_pose.calls == calls + 1
    assert refine_kernel.refine_pose.launches == launches
    dfm = args[4]
    corr = torch.stack([torch.arange(m, dtype=torch.int32), dfm], -1)
    want = refine.gauss_newton_refine(p["camera"], p["pre_gn"], p["markers_h"], p["det"].xy, corr,
                                      (dfm >= 0) & p["marker_mask"], 25, 1e-4)
    for g, w in zip(got, (want.pose, want.covariance, want.num_iterations)):
        _same(g, w)
    assert got.num_iterations.dtype == torch.int32 and got.num_iterations.shape == ()


@pytest.mark.parametrize("m", [4, 5, 9])
def test_refine_pose_plain_matches_jax_reference(m):
    """The twin against the JAX package's `pf/refine.py::gauss_newton_refine`
    on the same inputs, on the CPU, with three to eight live pairs (fewer
    leave the pose underdetermined).  XLA and torch sum the normal equations
    and the 3x3 products in other orders, so poses agree to 1e-5 and
    covariances to test_single_pose_gn_matches_reference's 1e-2 (an
    ill-conditioned 6x6 inverse moves by ~1e-3 under a one-ulp change of
    its input), with the same iteration count."""
    p, args = _pose_args("clean", m)
    dfm = args[4].numpy()
    corr = np.stack([np.arange(m, dtype=np.int32), dfm], -1)
    want = ref_gn(RefCamera.create(**refine_cases.CAM), jnp.asarray(p["pre_gn"].numpy()),
                  jnp.asarray(p["markers_h"].numpy()), jnp.asarray(p["det"].xy.numpy()),
                  jnp.asarray(corr), jnp.asarray((dfm >= 0) & p["marker_mask"].numpy()), 25,
                  1e-4)
    got = refine_kernel.refine_pose(*args, 25, 1e-4)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), rtol=0, atol=1e-5)
    assert int(got.num_iterations) == int(want.num_iterations)
    np.testing.assert_allclose(got.covariance.numpy(), np.asarray(want.covariance), rtol=1e-2,
                               atol=1e-6)


def test_ipe_tracker_with_and_without_pallas_gn(monkeypatch):
    """The IPE golden frames (tests/test_torch_ipe.py's settings) through the
    tracker with `use_pallas_gn` on, which refines through `refine_pose`, and
    off, which runs `gauss_newton_refine` op by op: flags, `pose_updated`,
    the track counter and the IPE counters equal; poses within
    tests/test_torch_ipe.py's bars (0.05 mm, 0.1 deg).  On the CPU the twin
    runs, so every refine counts its iterations as run from the host."""
    d = np.load(os.path.join(os.path.dirname(__file__), "golden", "golden_sequence.npz"))
    cam = Camera.create(float(d["fx"]), float(d["fy"]), float(d["cx"]), float(d["cy"]),
                        np.asarray(d["dist"], np.float32), int(d["width"]), int(d["height"]))
    markers = torch.from_numpy(np.concatenate([d["markers"], np.ones((5, 1), np.float32)], 1))
    ipe = dict(use_particle_filter=False, n_particles=64, min_blob_area=8.0)
    runs = {}
    for pallas in (True, False):
        step = make_tracker(cam, markers, torch.ones(5, dtype=torch.bool),
                            TrackerConfig(use_pallas_gn=pallas, **ipe), device="cpu")
        monkeypatch.setattr(port_step, "ipe_counts", port_step.IpeCounts())
        calls = refine_kernel.refine_pose.calls
        state = TargetState.create(64, prng_key(0), device="cpu")
        out = []
        for i in range(8):
            state, res = step(state, torch.from_numpy(d["frames"][i]), float(d["times"][i]))
            out.append((int(res.fail_flag), bool(res.pose_updated), res.pose.numpy()))
        counts = port_step.ipe_counts
        runs[pallas] = dict(out=out, it=int(state.it_since_initialized),
                            counts={k: getattr(counts, k) for k in type(counts).__slots__},
                            calls=refine_kernel.refine_pose.calls - calls)
    on, off = runs[True], runs[False]
    assert on["calls"] == 8 and off["calls"] == 0
    assert on["it"] == off["it"] and on["counts"] == off["counts"]
    assert on["counts"]["gn_iterations"] == 7 * 25
    for (f1, u1, p), (f2, u2, q) in zip(on["out"], off["out"]):
        assert f1 == f2 and u1 == u2
        assert np.linalg.norm(p[:3, 3] - q[:3, 3]) < 5e-5
        cos = np.clip((np.trace(p[:3, :3] @ q[:3, :3].T) - 1) / 2, -1, 1)
        assert np.degrees(np.arccos(cos)) < 0.1
