"""PF iteration: kernel B's plain version against the folded Pallas kernel
in interpret mode, the stratified ancestors against the reference's sort
scheme, and kernel C's plain gather against the reference's
top-pin -> gather -> restore-pin chain (both pins in interpret mode).

Draws: the interpret build of the Pallas kernel feeds it
`jax.random.uniform` rows, the same counter stream the port hashes in
the kernel, so both sides propagate with the same uniforms.  XLA on the
CPU contracts some multiply-adds of the interpret build into FMAs; the
port rounds every product (as Mosaic and the --fmad=false CUDA kernel
do), so the banks agree to float32 ulps and the weights to 1e-4.

The interpret-mode comparison uses K = 8 detection slots (the Pallas
interpreter's compile time grows with the K x M volume: ~19 s at K = 8
against ~60 s at K = 16 on this CPU); the plain twin takes any K, and
chip_smoke.py / test_torch_kernels_cuda.py hold the CUDA kernel to it at
the main path's K = 16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf_monocular_pose_estimator_tpu.geometry.camera import Camera as RefCamera
from pf_monocular_pose_estimator_tpu.pf.pallas_step import (
    bank_restore_pin,
    bank_top_pin,
    fused_propagate_weight_pallas,
)
from pf_monocular_pose_estimator_tpu.pf.propagate import NoiseBounds as RefNoise
from pf_monocular_pose_estimator_tpu.pf.propagate import propagation_noise_factors as ref_factors
from pf_monocular_pose_estimator_tpu.pf.soa import gather_soa, stratified_resample_soa
from pf_monocular_pose_estimator_tpu.pf.weight import weight_particles as ref_weight
from pf_monocular_pose_estimator_tpu_torch.geometry import Camera, exp_se3
from pf_monocular_pose_estimator_tpu_torch.pf import soa, step_kernel
from pf_monocular_pose_estimator_tpu_torch.pf.propagate import NoiseBounds, propagation_noise_factors
from pf_monocular_pose_estimator_tpu_torch.pf.weight import weight_particles

torch.set_num_threads(2)

CAM = dict(fx=420.0, fy=418.0, cx=376.0, cy=240.0)


def _pose(rng, scale, z=1.2):
    tw = rng.normal(0, scale, 6).astype(np.float32)
    p = exp_se3(torch.from_numpy(tw)).numpy()
    p[2, 3] += z
    return p


def _setup(seed, n, k=16):
    rng = np.random.default_rng(seed)
    markers = np.concatenate([rng.normal(0, 0.08, (5, 3)), np.ones((5, 1))], 1).astype(np.float32)
    gt = _pose(rng, 0.3)
    pts = (gt @ markers.T)[:3]
    uv = np.stack([CAM["fx"] * pts[0] / pts[2] + CAM["cx"], CAM["fy"] * pts[1] / pts[2] + CAM["cy"]], 1)
    det_xy = np.zeros((k, 2), np.float32)
    det_xy[:5] = uv + rng.normal(0, 0.4, (5, 2))
    det_xy[5] = det_xy[1] + 2.0  # a near-clone, so reuse penalties fire
    det_mask = np.zeros(k, bool)
    det_mask[:6] = True
    tw = rng.normal(0, 0.02, (n, 6)).astype(np.float32)
    bank = (exp_se3(torch.from_numpy(tw)) @ torch.from_numpy(gt)).reshape(n, 16).T.contiguous()
    return dict(
        key=jax.random.PRNGKey(seed), bank16=bank.numpy(), cur=_pose(rng, 0.3), pred=_pose(rng, 0.3),
        predm=_pose(rng, 0.01, 0.0), cmi=_pose(rng, 0.01, 0.0), markers=markers,
        marker_mask=np.array([True, True, True, True, False]), det_xy=det_xy, det_mask=det_mask,
        downgrade=np.array([False, True, False, False, False]),
    )


@pytest.mark.parametrize("tracking,apply_pred,seed", [(True, True, 0), (False, False, 1),
                                                      (True, False, 2)])
def test_fused_propagate_weight_matches_pallas(tracking, apply_pred, seed):
    n = 2048
    s = _setup(seed, n, k=8)
    ref_cam = RefCamera.create(**CAM)
    noise = dict(min_translation=-0.01, max_translation=0.01, min_angular=-0.02, max_angular=0.02)
    fac_t = np.float32([0.3, 0.3, 0.3])
    fac_r = np.float32([0.2, 0.2, 0.2])
    want_bank, want_w = fused_propagate_weight_pallas(
        s["key"], jnp.asarray(s["bank16"]), jnp.asarray(s["cur"]), jnp.asarray(s["pred"]),
        jnp.asarray(s["predm"]), jnp.asarray(s["cmi"]), RefNoise(**noise), jnp.asarray(fac_t),
        jnp.asarray(fac_r), tracking, apply_pred, jnp.float32(1.025), ref_cam,
        jnp.asarray(s["markers"]), jnp.asarray(s["marker_mask"]), jnp.asarray(s["det_xy"]),
        jnp.asarray(s["det_mask"]), 10.0, 5.0, jnp.asarray(s["downgrade"]), None,
        block=1024, interpret=True, want_pairs=False, folded=True,
    )
    t = lambda a: torch.from_numpy(np.array(a))
    got_bank, got_w = step_kernel.fused_propagate_weight(
        tuple(np.asarray(s["key"]).tolist()), t(s["bank16"]), t(s["cur"]), t(s["pred"]), t(s["predm"]),
        t(s["cmi"]), NoiseBounds(**noise), t(fac_t), t(fac_r), tracking, apply_pred, 1.025,
        Camera.create(**CAM), t(s["markers"]), t(s["marker_mask"]), t(s["det_xy"]),
        t(s["det_mask"]), 10.0, 5.0, t(s["downgrade"]), want_pairs=False,
    )
    want_bank = np.asarray(want_bank)
    np.testing.assert_allclose(got_bank.numpy(), want_bank, rtol=2e-6, atol=2e-7)
    np.testing.assert_array_equal(got_bank.numpy()[:, :2], want_bank[:, :2])  # pinned lanes
    want_w = np.asarray(want_w)
    np.testing.assert_allclose(got_w.numpy(), want_w, rtol=0, atol=1e-4)
    assert want_w.max() > 15.0  # particles matched


def test_noise_factors_match_reference():
    rng = np.random.default_rng(5)
    predm = _pose(rng, 0.05, 0.0)
    for fresh in (True, False):
        want = ref_factors(jnp.asarray(fresh), jnp.asarray(predm), jnp.float32(0.04))
        got = propagation_noise_factors(fresh, torch.from_numpy(predm), torch.tensor(0.04))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _weights(rng, n, kind):
    if kind == "peaked":
        w = np.zeros(n, np.float32)
        w[rng.choice(n, 40, replace=False)] = rng.uniform(10, 30, 40).astype(np.float32)
        return w
    if kind == "zeros":
        return np.zeros(n, np.float32)
    w = rng.uniform(0, 30, n).astype(np.float32)
    w[rng.random(n) < 0.4] = 0.0  # the tolerance gate's zero lanes
    return w


@pytest.mark.parametrize("n,kind", [(2048, "sparse"), (2048, "peaked"), (2048, "zeros"),
                                    (100_000, "sparse")])
def test_stratified_ancestors_exact(n, kind):
    rng = np.random.default_rng(n + len(kind))
    w = _weights(rng, n, kind)
    wn = w / max(w.sum(), 1e-12) if w.sum() > 0 else w
    key = jax.random.PRNGKey(n)
    anc, counts, most = stratified_resample_soa(key, jnp.asarray(wn))
    g_anc, g_counts, g_most = soa.stratified_resample_soa(tuple(np.asarray(key).tolist()),
                                                         torch.from_numpy(wn))
    np.testing.assert_array_equal(g_anc.numpy(), np.asarray(anc))
    np.testing.assert_array_equal(g_counts.numpy(), np.asarray(counts))
    assert int(g_most) == int(most)


def test_chunked_cdf_bound():
    with pytest.raises(ValueError):
        soa.chunked_cdf_norm(torch.zeros(2**24 + 8), 8)


def test_resample_gather_exact_vs_pins():
    rng = np.random.default_rng(7)
    n = 4096
    s = _setup(7, n)
    w = _weights(rng, n, "sparse")
    anc, _, _ = stratified_resample_soa(jax.random.PRNGKey(1), jnp.asarray(w / w.sum()))
    bank = jnp.asarray(s["bank16"])
    want = np.asarray(bank_restore_pin(gather_soa(bank_top_pin(bank, interpret=True), anc),
                                       interpret=True))
    got = step_kernel.resample_gather(torch.from_numpy(s["bank16"]),
                                      torch.from_numpy(np.array(anc)).long())
    np.testing.assert_array_equal(got.numpy(), want)


def test_single_pose_weight_matches_reference():
    """pf/weight.py (detection-major ties), used for the best particle's pairs."""
    s = _setup(3, 8)
    poses = s["bank16"].T.reshape(8, 4, 4)
    args = (s["markers"], s["marker_mask"], s["det_xy"], s["det_mask"], 10.0, 5.0, s["downgrade"])
    want = ref_weight(RefCamera.create(**CAM), jnp.asarray(poses), *map(jnp.asarray, args[:4]),
                      10.0, 5.0, jnp.asarray(args[6]))
    got = weight_particles(Camera.create(**CAM), torch.from_numpy(np.ascontiguousarray(poses)),
                           *map(torch.from_numpy, args[:4]), 10.0, 5.0, torch.from_numpy(args[6]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
