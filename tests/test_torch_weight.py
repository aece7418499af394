"""The PF weight with pairs: kernel E's plain version against
`weight_particles_pallas` and kernel B's pairs variant against the straight
`fused_propagate_weight_pallas(want_pairs=True)`, both in interpret mode
(marker-major ties); the reference's XLA propagation and detection-major
weight (`pf/soa.py`) against their torch counterparts.

Tolerances: pairs and pair counts are integers and must be equal.  XLA on
the CPU contracts some multiply-adds into FMAs where the port rounds every
product, so banks agree to float32 ulps (rtol 2e-6, atol 2e-7) and weights
to 1e-4.  The interpret runs use K = 8 detection slots (the interpreter's
compile time grows with the K x M volume); chip_smoke.py holds the kernels
to these plain versions at K = 16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf_monocular_pose_estimator_tpu.geometry.camera import Camera as RefCamera
from pf_monocular_pose_estimator_tpu.pf.pallas_step import fused_propagate_weight_pallas
from pf_monocular_pose_estimator_tpu.pf.pallas_weight import weight_particles_pallas
from pf_monocular_pose_estimator_tpu.pf.propagate import NoiseBounds as RefNoise
from pf_monocular_pose_estimator_tpu.pf.soa import propagate_soa as ref_propagate
from pf_monocular_pose_estimator_tpu.pf.soa import weight_particles_soa as ref_weight_soa
from pf_monocular_pose_estimator_tpu_torch.geometry import Camera
from pf_monocular_pose_estimator_tpu_torch.pf import soa, step_kernel, weight_kernel
from pf_monocular_pose_estimator_tpu_torch.pf.propagate import NoiseBounds
from test_torch_kernels_cuda import GREEDY_CAM, GREEDY_CASES, greedy_edge_lanes
from test_torch_pf_step import CAM, _setup

torch.set_num_threads(2)

NOISE = dict(min_translation=-0.01, max_translation=0.01, min_angular=-0.02, max_angular=0.02)
t = lambda a: torch.from_numpy(np.array(a))


def _weigh_args(s, jnp_side: bool):
    f = jnp.asarray if jnp_side else t
    return (f(s["markers"]), f(s["marker_mask"]), f(s["det_xy"]), f(s["det_mask"]), 10.0, 5.0,
            f(s["downgrade"]))


@pytest.mark.parametrize("seed,n", [(0, 600), (1, 777)])
def test_weight_kernel_plain_matches_pallas(seed, n):
    """Kernel E's plain version (marker-major) against the Pallas kernel."""
    s = _setup(seed, n, k=8)
    want = weight_particles_pallas(RefCamera.create(**CAM), jnp.asarray(s["bank16"]),
                                   *_weigh_args(s, True), None, block=256, interpret=True)
    got = weight_kernel.weight_particles_bank(Camera.create(**CAM), t(s["bank16"]),
                                              *_weigh_args(s, False))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-4)
    assert np.asarray(want[2]).max() >= 4  # particles matched most markers


@pytest.mark.parametrize("m", range(3, 9))
@pytest.mark.parametrize("case", GREEDY_CASES)
def test_weight_plain_edge_cases_match_pallas(case, m):
    """Kernel E's plain version against the Pallas kernel on the lanes the
    card holds kernels B and E to (`greedy_edge_lanes`, K = 16, a ragged
    N): ties across markers and within a row, reuse, masked markers and
    detections, every cell masked, NaN and +-inf pose rows, overflowing
    distances, tol_pf at inf and above sqrt(3e37).  A NaN cell leaves the
    lane without a pair on both sides (the minimum is NaN).  Pairs and
    counts equal; weights to 1e-4 or 1e-6 relative (they reach 1e36 and
    inf here)."""
    bank, a, _ = greedy_edge_lanes(case, m, 16, 517)
    order = ("markers_h", "marker_mask", "det_xy", "det_mask", "tol_pf", "tol_init", "downgrade")
    want = weight_particles_pallas(RefCamera.create(**GREEDY_CAM), jnp.asarray(bank),
                                   *(jnp.asarray(a[n]) for n in order), None, block=1024,
                                   interpret=True)
    got = weight_kernel.weight_particles_bank(Camera.create(**GREEDY_CAM), t(bank),
                                              *(torch.as_tensor(a[n]) for n in order))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-4)
    no_pair = np.isnan(bank[:12]).any(0)
    assert no_pair.sum() >= 12 and (got[2].numpy()[no_pair] == 0).all()


def test_pf_step_pairs_variant_matches_straight_pallas():
    """Kernel B's pairs variant (#4) against the straight Pallas kernel."""
    n = 1024
    s = _setup(4, n, k=8)
    fac_t, fac_r = np.float32([0.3] * 3), np.float32([0.2] * 3)
    want = fused_propagate_weight_pallas(
        s["key"], jnp.asarray(s["bank16"]), jnp.asarray(s["cur"]), jnp.asarray(s["pred"]),
        jnp.asarray(s["predm"]), jnp.asarray(s["cmi"]), RefNoise(**NOISE), jnp.asarray(fac_t),
        jnp.asarray(fac_r), True, True, jnp.float32(1.0), RefCamera.create(**CAM),
        *_weigh_args(s, True), None, block=512, interpret=True, want_pairs=True, folded=False,
    )
    got = step_kernel.fused_propagate_weight(
        tuple(np.asarray(s["key"]).tolist()), t(s["bank16"]), t(s["cur"]), t(s["pred"]),
        t(s["predm"]), t(s["cmi"]), NoiseBounds(**NOISE), t(fac_t), t(fac_r), True, True, 1.0,
        Camera.create(**CAM), *_weigh_args(s, False), want_pairs=True,
    )
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=2e-6, atol=2e-7)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    # the pairs variant leaves the bank and the weights as the weights-only pass has them
    bank_w, w_w = step_kernel.fused_propagate_weight(
        tuple(np.asarray(s["key"]).tolist()), t(s["bank16"]), t(s["cur"]), t(s["pred"]),
        t(s["predm"]), t(s["cmi"]), NoiseBounds(**NOISE), t(fac_t), t(fac_r), True, True, 1.0,
        Camera.create(**CAM), *_weigh_args(s, False), want_pairs=False,
    )
    assert torch.equal(bank_w, got[0]) and torch.equal(w_w, got[1])


def test_detection_major_weight_matches_xla():
    """`use_pallas_weight=False`: the reference's XLA weight, detection-major ties."""
    s = _setup(5, 3000)
    want = ref_weight_soa(RefCamera.create(**CAM), jnp.asarray(s["bank16"]), *_weigh_args(s, True))
    got = soa.weight_particles_soa(Camera.create(**CAM), t(s["bank16"]), *_weigh_args(s, False))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-4)


@pytest.mark.parametrize("tracking,apply_pred", [(True, True), (True, False), (False, False)])
def test_propagate_soa_matches_xla(tracking, apply_pred):
    """`use_fused_pf_kernel=False`: the reference's XLA propagation."""
    s = _setup(6, 3000)
    fac_t, fac_r = np.float32([0.3] * 3), np.float32([0.2] * 3)
    want = np.asarray(ref_propagate(
        s["key"], jnp.asarray(s["bank16"]), jnp.asarray(s["cur"]), jnp.asarray(s["pred"]),
        jnp.asarray(s["predm"]), jnp.asarray(s["cmi"]), RefNoise(**NOISE), jnp.asarray(fac_t),
        jnp.asarray(fac_r), jnp.asarray(tracking), jnp.asarray(apply_pred), jnp.float32(1.025)))
    got = soa.propagate_soa(
        tuple(np.asarray(s["key"]).tolist()), t(s["bank16"]), t(s["cur"]), t(s["pred"]),
        t(s["predm"]), t(s["cmi"]), NoiseBounds(**NOISE), t(fac_t), t(fac_r), tracking,
        apply_pred, 1.025).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-7)
    np.testing.assert_array_equal(got[:, :2], want[:, :2])  # lanes 0 / 1 set exactly
