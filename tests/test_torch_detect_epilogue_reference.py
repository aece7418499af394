"""The crop path's epilogue against the JAX package.

`detect_epilogue` on the CPU (its plain twin), after kernel A's plain
`detect_stats`, is held to the JAX package's crop path,
`ops/blob.py::_detect_blobs_fused` with its Pallas kernel in interpret
mode, and its `undistort_pixels`: on crops of merged, elongated, touching,
no and only foreground blobs, over every combination of `split_merged`,
`split_dip_ratio` and `active_markers`, at K = 1, 16 and 128, with a crop
offset and a distorting camera.  The mask and the areas are equal, the
kept slots' centroids within 1e-4 px, the dropped slots zero."""

import epilogue_cases as cases
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf_monocular_pose_estimator_tpu.geometry.camera import Camera as RefCamera
from pf_monocular_pose_estimator_tpu.geometry.camera import undistort_pixels
from pf_monocular_pose_estimator_tpu.ops.blob import BlobParams as RefBlobParams
from pf_monocular_pose_estimator_tpu.ops.blob import _detect_blobs_fused
from pf_monocular_pose_estimator_tpu_torch.ops import detect_kernel as dk

torch.set_num_threads(2)

CROP = (96, 128)
OFFSET = (300.0, 150.0)  # where the crop lies in the frame (x, y)


@pytest.mark.parametrize("k", [1, 16, 128])
@pytest.mark.parametrize("option", list(cases.OPTIONS))
@pytest.mark.parametrize("case", cases.CROPS)
def test_epilogue_matches_the_jax_crop_path(case, option, k):
    params = cases.params(option, k)
    ref_params = RefBlobParams(**{f: getattr(params, f) for f in RefBlobParams._fields})
    h, w = CROP
    img = cases.crop(case, h, w, params.active_markers)
    roi = np.float32([4.0, 4.0, w - 8.0, h - 8.0])
    xy_d, mask, area = (np.asarray(v) for v in _detect_blobs_fused(
        jnp.asarray(img), jnp.asarray(roi), ref_params, jnp.float32(cases.MIN_AREA),
        jnp.float32(cases.MAX_AREA), interpret=True))
    xy_d = xy_d + np.float32(OFFSET)
    ref_cam = RefCamera.create(420.0, 418.0, 376.0, 240.0, np.float32(cases.DIST))
    xy_u = np.asarray(undistort_pixels(ref_cam, jnp.asarray(xy_d)))

    prm = cases.epilogue_params(roi, params.threshold, params.max_width_height_distortion,
                                params.max_circular_distortion, OFFSET, "cpu")
    crop = torch.from_numpy(img)
    lab, maps, top = dk.detect_stats(crop, prm[:12], 5, params.active_markers,
                                     params.cc_sweeps, k)
    got = dk.detect_epilogue(lab, maps, top, crop, prm, 5, params, cases.camera())
    g_xy, g_xy_d, g_mask, g_area, g_falses = (t.numpy() for t in got)

    np.testing.assert_array_equal(g_mask, mask)
    np.testing.assert_array_equal(g_area, np.where(mask, area, 0.0))
    np.testing.assert_allclose(g_xy_d[mask], xy_d[mask], rtol=0, atol=1e-4)
    np.testing.assert_allclose(g_xy[mask], xy_u[mask], rtol=0, atol=1e-4)
    assert not g_xy_d[~mask].any() and not g_xy[~mask].any() and not g_falses.any()
    assert mask.any() or case in ("empty", "full", "touching")
