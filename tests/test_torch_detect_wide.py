"""Kernel A's plain twin beyond the tracker's default shapes -- 13 to 32
sweeps and a top-k of 64 to 128, which run the wide path on the card --
against the reference's Pallas kernel in interpret mode, bit for bit.  The
card holds the kernel to this twin at these shapes and the rest of the grid
(`tests/test_torch_kernels_cuda.py`, chip_smoke.py's [shapes] phase)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf_monocular_pose_estimator_tpu.ops.pallas_kernels import detect_stats_pallas
from pf_monocular_pose_estimator_tpu_torch.ops import detect_kernel as dk

torch.set_num_threads(2)


def _band_crop(h=64, w=96):
    """A 64x96 crop of 144 dots of one area (more components than the
    largest top-k, ranked by flat index among equals), a band across the
    whole width and a shorter chain under it, whose labels still change at
    the last sweep."""
    img = np.zeros((h, w), np.float32)
    img[2:51:6, 2:w - 3:6] = 255.0
    img[56:59, :] = 255.0
    img[62, 10:80] = 255.0
    return img


@pytest.mark.parametrize("sweeps,topk", [(13, 64), (20, 100), (32, 128)])
def test_detect_stats_wide_matches_pallas(sweeps, topk):
    img = _band_crop()
    roi = np.float32([0.0, 0.0, 96.0, 64.0])
    ref = detect_stats_pallas(jnp.asarray(img), jnp.asarray(roi), 240.0, 0.6, True, sweeps,
                              interpret=True, second_moments=True, topk=topk, min_area=8.0,
                              max_area=160.0)
    ref = [np.asarray(r) for r in ref]
    prm = dk.make_params(roi, 240.0, 8.0, 160.0, 0.6, "cpu")
    lab, maps, top = dk.detect_stats(torch.from_numpy(img), prm, 5, True, sweeps, topk)
    np.testing.assert_array_equal(lab.numpy(), ref[0])
    for i in range(dk.N_MAPS):
        np.testing.assert_array_equal(maps[i].numpy(), ref[1 + i], err_msg=f"map {i}")
    np.testing.assert_array_equal(top.numpy(), ref[11][0])
    roots = int((lab.numpy().ravel() == np.arange(1, lab.numel() + 1)).sum())
    assert roots > topk
    # the last sweep still moves labels: the case needs every sweep
    fg = dk.threshold_blur(torch.from_numpy(img), prm, 5) > 1e-3
    assert not torch.equal(dk.label_sweeps(fg, sweeps - 1), lab)
