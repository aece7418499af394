"""Detection: kernel A's plain versions against the Pallas kernels run in
interpret mode (the Pallas semantics: zero blur borders, exact component
counts for the ranking), and the port's `find_leds` on the golden frames.

On the CPU the kernel wrappers take their plain versions, which are what
the CUDA kernels are held to on the card (chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf_monocular_pose_estimator_tpu.geometry.camera import Camera as RefCamera
from pf_monocular_pose_estimator_tpu.ops.blob import BlobParams as RefBlobParams
from pf_monocular_pose_estimator_tpu.ops.blob import _detect_blobs_fused
from pf_monocular_pose_estimator_tpu.ops.pallas_kernels import (
    detect_stats_pallas,
    threshold_blur_pallas,
)
from pf_monocular_pose_estimator_tpu_torch.geometry import Camera
from pf_monocular_pose_estimator_tpu_torch.ops import blob
from pf_monocular_pose_estimator_tpu_torch.ops import detect_kernel as dk
from pf_monocular_pose_estimator_tpu_torch.utils import BlobParams

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def golden():
    import os

    return np.load(os.path.join(os.path.dirname(__file__), "golden", "golden_sequence.npz"))


def _crop(d, i):
    led = d["led_pixels"][i]
    x0 = int(np.clip(round(led[:, 0].mean() - 128), 0, 752 - 256))
    y0 = int(np.clip(round(led[:, 1].mean() - 96), 0, 480 - 192))
    return np.ascontiguousarray(d["frames"][i][y0:y0 + 192, x0:x0 + 256].astype(np.float32))


@pytest.mark.parametrize("active,thr", [(True, 240.0), (False, 60.0)])
def test_threshold_blur_matches_pallas(golden, active, thr):
    """Pallas side: threshold_blur_pallas(interpret=True).  XLA on the CPU
    contracts the tap sums into FMAs; the port rounds every product (as
    Mosaic and the --fmad=false kernel do), so values agree to 2 ulp."""
    frame = golden["frames"][0].astype(np.float32)
    roi = np.float32([30.0, 20.0, 600.0, 400.0])
    want = np.asarray(threshold_blur_pallas(jnp.asarray(frame), jnp.asarray(roi), thr, 0.6, active,
                                            interpret=True))
    prm = dk.make_params(roi, thr, 8.0, 160.0, 0.6, "cpu")
    got = dk.threshold_blur(torch.from_numpy(frame), prm, 5, active).numpy()
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=1e-30)
    assert ((got > 1e-3) == (want > 1e-3)).all()


def _tied_crop(h=64, w=96):
    """Identical 3x3 saturated squares every 10 px: 54 components of one
    area, so the top-16 is decided by the flat index."""
    img = np.zeros((h, w), np.float32)
    for y in range(4, h - 4, 10):
        for x in range(4, w - 4, 10):
            img[y - 1:y + 2, x - 1:x + 2] = 255.0
    return img


@pytest.mark.parametrize("case", [17, 41, "tied", "empty"])
def test_detect_stats_exact_vs_pallas(golden, case):
    """Labels, counts, moment sums, bbox maps and the top-16 are exact: on
    two golden crops, on a 64x96 crop of more than 16 components of tied
    areas, and on one with no foreground (the top-16 are score-0 pixels)."""
    if case == "tied":
        crop, roi = _tied_crop(), np.float32([0.0, 0.0, 96.0, 64.0])
    elif case == "empty":
        crop = np.random.default_rng(3).uniform(0, 200, (64, 96)).astype(np.float32)
        roi = np.float32([0.0, 0.0, 96.0, 64.0])
    else:
        crop, roi = _crop(golden, case), np.float32([6.0, 9.0, 240.0, 170.0])
    ref = detect_stats_pallas(jnp.asarray(crop), jnp.asarray(roi), 240.0, 0.6, True, 12,
                              interpret=True, second_moments=True, topk=16, min_area=8.0,
                              max_area=160.0)
    ref = [np.asarray(r) for r in ref]
    prm = dk.make_params(roi, 240.0, 8.0, 160.0, 0.6, "cpu")
    lab, maps, top = dk.detect_stats(torch.from_numpy(crop), prm, 5, True, 12, 16)
    np.testing.assert_array_equal(lab.numpy(), ref[0])
    for i in range(dk.N_MAPS):
        np.testing.assert_array_equal(maps[i].numpy(), ref[1 + i], err_msg=f"map {i}")
    np.testing.assert_array_equal(top.numpy(), ref[11][0])
    roots = int((lab.numpy().ravel() == np.arange(1, lab.numel() + 1)).sum())
    if case == "empty":
        assert roots == 0 and top.tolist() == list(range(16))
    else:
        assert (lab.numpy() > 0).sum() > 50 and roots >= (17 if case == "tied" else 5)


def test_fused_crop_detections_match_pallas(golden):
    """The crop path's detections (kernel A + `detect_epilogue`: shape
    filters, splitter, compaction) against the reference's
    `_detect_blobs_fused` in interpret mode; the epilogue zeroes the slots
    the mask drops."""
    crop = _crop(golden, 23)
    roi = np.float32([4.0, 6.0, 244.0, 176.0])
    params = BlobParams(min_blob_area=8.0)
    ref_params = RefBlobParams(min_blob_area=8.0)
    want = _detect_blobs_fused(jnp.asarray(crop), jnp.asarray(roi), ref_params, jnp.float32(8.0),
                               jnp.float32(160.0), interpret=True)
    want = [np.asarray(v) for v in want]
    img = torch.from_numpy(crop)
    prm = torch.cat([dk.make_params(roi, 240.0, 8.0, 160.0, 0.6, "cpu"),
                     torch.tensor([0.7, 0.7, 0.0, 0.0])])
    lab, maps, top = dk.detect_stats(img, prm[:12], 5, True, 12, 16)
    _, xy_d, mask, area, falses = dk.detect_epilogue(lab, maps, top, img, prm, 5, params,
                                                     _camera(golden))
    np.testing.assert_array_equal(mask.numpy(), want[1])
    np.testing.assert_allclose(xy_d.numpy(), np.where(want[1][:, None], want[0], 0.0), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(area.numpy(), want[2])
    assert int(mask.sum()) == 5 and not falses.any()


def _camera(d):
    return Camera.create(float(d["fx"]), float(d["fy"]), float(d["cx"]), float(d["cy"]),
                         np.asarray(d["dist"], np.float32), int(d["width"]), int(d["height"]))


def test_find_leds_full_frame_on_golden_frames(golden):
    """tests/test_golden_sequence.py's bar: every LED within 0.5 px of
    where OpenCV rendered it (full-frame path: kernel A's threshold_blur)."""
    cam = _camera(golden)
    params = BlobParams(min_blob_area=8.0)
    roi = torch.tensor([0.0, 0.0, 752.0, 480.0])
    for i in (0, 17, 41, 59):
        det = blob.find_leds(torch.from_numpy(golden["frames"][i]), roi, params, cam)
        got = det.xy_distorted[det.mask].numpy()
        expected = golden["led_pixels"][i]
        assert len(got) == len(expected), f"frame {i}: {len(got)} blobs"
        dists = np.linalg.norm(got[None] - expected[:, None], axis=-1)
        assert (dists.min(axis=1) < 0.5).all(), dists.min(axis=1)


def test_find_leds_crop_path_on_golden_frame(golden):
    """A small ROI takes the 192x256 crop path (kernel A's detect_stats)
    and finds the same LEDs, undistorted like the reference's."""
    cam = _camera(golden)
    ref_cam = RefCamera.create(float(golden["fx"]), float(golden["fy"]), float(golden["cx"]),
                               float(golden["cy"]), np.asarray(golden["dist"], np.float32))
    led = golden["led_pixels"][41]
    lo, hi = led.min(0) - 15, led.max(0) + 15
    roi = torch.tensor([lo[0], lo[1], hi[0] - lo[0], hi[1] - lo[1]], dtype=torch.float32)
    det = blob.find_leds(torch.from_numpy(golden["frames"][41]), roi, BlobParams(min_blob_area=8.0),
                         cam)
    got = det.xy_distorted[det.mask].numpy()
    assert len(got) == 5
    dists = np.linalg.norm(got[None] - led[:, None], axis=-1)
    assert (dists.min(axis=1) < 0.5).all(), dists.min(axis=1)
    from pf_monocular_pose_estimator_tpu.geometry.camera import undistort_pixels

    want_u = np.asarray(undistort_pixels(ref_cam, jnp.asarray(got)))
    np.testing.assert_allclose(det.xy[det.mask].numpy(), want_u, rtol=0, atol=1e-3)


def test_roi_helpers_match_reference(golden):
    from pf_monocular_pose_estimator_tpu.ops.blob import determine_roi, grow_roi

    cam = _camera(golden)
    ref_cam = RefCamera.create(float(golden["fx"]), float(golden["fy"]), float(golden["cx"]),
                               float(golden["cy"]), np.asarray(golden["dist"], np.float32))
    rng = np.random.default_rng(4)
    pix = rng.uniform([100, 80], [500, 300], (40, 2)).astype(np.float32)
    mask = rng.random(40) > 0.3
    want = np.asarray(determine_roi(jnp.asarray(pix), jnp.asarray(mask), ref_cam, 10.0))
    got = blob.determine_roi(torch.from_numpy(pix), torch.from_numpy(mask), cam, 10.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    grown = blob.grow_roi(torch.from_numpy(got), 20.0, 20.0, cam).numpy()
    np.testing.assert_allclose(grown, np.asarray(grow_roi(jnp.asarray(want), 20.0, 20.0, ref_cam)),
                               rtol=0, atol=1e-3)
