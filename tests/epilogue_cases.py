"""Crops, options and a camera for the tests of `detect_epilogue`: the CPU
twin against the parent's op-by-op code (tests/test_torch_detect_epilogue.py)
and the kernel against the twin on the card (tests/test_torch_kernels_cuda.py).

Areas are set so the crops reach every branch of the splitter: with
min 8 and max 72, a pair of discs 2 px apart (86 px after the blur's halo)
splits on the dip between them, a pair that touches (106 px) and a bar
(77 px) split only without the dip test, and round LEDs and specks pass
the shape filters while the full crop's square pieces fail them."""

import numpy as np
import torch

from pf_monocular_pose_estimator_tpu_torch.geometry import Camera
from pf_monocular_pose_estimator_tpu_torch.ops import detect_kernel as dk
from pf_monocular_pose_estimator_tpu_torch.utils import BlobParams

MIN_AREA, MAX_AREA = 8.0, 72.0
THRESHOLD = {True: 240.0, False: 60.0}  # active markers, passive (dark) ones
CROPS = ("merged", "elongated", "touching", "empty", "full")
# split_merged, split_dip_ratio, active_markers: every combination
OPTIONS = {
    f"{'split' if s else 'nosplit'}-{'dip' if d < 1e6 else 'nodip'}-"
    f"{'active' if a else 'passive'}": dict(split_merged=s, split_dip_ratio=d, active_markers=a)
    for s in (True, False) for d in (0.75, 1e7) for a in (True, False)
}
DIST = [-0.31, 0.12, 0.0013, -0.0021, -0.024]  # plumb bob, as a wide-angle lens reads


def camera(device="cpu") -> Camera:
    return Camera.create(420.0, 418.0, 376.0, 240.0, np.float32(DIST), device=device)


def params(option: str, k: int, **more) -> BlobParams:
    active = OPTIONS[option]["active_markers"]
    return BlobParams(threshold=THRESHOLD[active], min_blob_area=MIN_AREA,
                      max_blob_area=MAX_AREA, max_detections=k, **OPTIONS[option], **more)


def _disc(img, cy, cx, r, v=255.0):
    ys, xs = np.ogrid[: img.shape[0], : img.shape[1]]
    img[(ys - cy) ** 2 + (xs - cx) ** 2 <= r * r] = v


def crop(case: str, h: int, w: int, active: bool, seed: int = 0) -> np.ndarray:
    """An (h, w) float32 crop of bright blobs on a dim background, inverted
    (dark blobs on a bright one) for passive markers."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 100.0, (h, w)).astype(np.float32)
    if case == "full":
        img[:] = 255.0
    elif case == "merged":  # pairs of discs with a dip between them, one without
        for cy, cx in ((20, 20), (h // 2, w // 2), (h - 24, w - 30)):
            _disc(img, cy, cx, 1.5)
            _disc(img, cy + 1, cx + 5, 1.5)
        _disc(img, 20, w - 30, 2.0)
        _disc(img, 21, w - 26, 2.0)
        _disc(img, h // 2, 18, 2.0)  # and a round LED
    elif case == "elongated":  # bars with no waist, specks
        img[16:19, 20:27] = 255.0
        img[h // 2 - 3:h // 2 + 4, w // 2:w // 2 + 3] = 255.0
        img[h - 12, w - 12] = 255.0
        img[10:12, w - 20:w - 18] = 255.0
    elif case == "touching":  # discs a pixel apart, the same and different sizes
        for i, (r1, r2) in enumerate(((2.0, 2.0), (2.2, 1.5), (1.5, 1.5), (2.0, 1.5))):
            cy, cx = 16 + i * (h - 32) // 3, 20 + i * (w - 48) // 3
            _disc(img, cy, cx, r1)
            _disc(img, cy, cx + int(r1 + r2) + 1, r2, 250.0)
    # "empty": the background alone, below the threshold everywhere
    return img if active else (255.0 - img).astype(np.float32)


def epilogue_params(roi, threshold, wh_tol, circ_tol, offset, device) -> torch.Tensor:
    """The epilogue's vector: A's (make_params), then wh_tol, circ_tol and
    the crop offset."""
    base = dk.make_params(roi, threshold, MIN_AREA, MAX_AREA, 0.6, device)
    tail = torch.tensor([wh_tol, circ_tol, *offset], dtype=torch.float32, device=device)
    return torch.cat([base, tail])
