"""The crop path's epilogue (`ops/detect_kernel.py::detect_epilogue`).

On the CPU `find_leds` runs the epilogue's plain twin; it is held here,
bit for bit, to the parent's op-by-op code, which the benchmark keeps as a
frozen plain copy (`portbench/reference/ops/blob.py`): on golden frames,
and on crops of merged, elongated, touching, no and only foreground blobs
over every combination of `split_merged`, `split_dip_ratio` and
`active_markers`, at K = 1, 16 and 128, with a distorting camera.  The
wrapper's checks (the caller's types, the parameters' and the
distortion's lengths, one device, K within kernel A's range) raise on bad
input, and its counters and arguments are checked against a stand-in for
the kernel library.  The same grid is held to the JAX package in
tests/test_torch_detect_epilogue_reference.py, and the kernel to the twin
on the card in tests/test_torch_kernels_cuda.py."""

import os
import sys
from pathlib import Path

import epilogue_cases as cases
import numpy as np
import pytest
import torch

from pf_monocular_pose_estimator_tpu_torch.geometry import Camera
from pf_monocular_pose_estimator_tpu_torch.ops import blob
from pf_monocular_pose_estimator_tpu_torch.ops import detect_kernel as dk
from pf_monocular_pose_estimator_tpu_torch.utils import BlobParams, cuda_lib

BENCH = Path(__file__).resolve().parents[1] / "portbench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from reference.ops import blob as parent_blob  # noqa: E402

torch.set_num_threads(2)

FIELDS = ("xy", "xy_distorted", "mask", "area", "occluded", "injected")
CROP = (96, 128)  # the synthetic crops' size (roi_crop)
AT = (150, 300)  # where they lie in the frame (y, x)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same_banks(got, want):
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(_bits(g), _bits(w)), name


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(os.path.dirname(__file__), "golden", "golden_sequence.npz"))


def _golden_camera(d) -> Camera:
    return Camera.create(float(d["fx"]), float(d["fy"]), float(d["cx"]), float(d["cy"]),
                         np.asarray(d["dist"], np.float32), int(d["width"]), int(d["height"]))


@pytest.mark.parametrize("given", ["defaults", "tensors"])
@pytest.mark.parametrize("frame", [0, 23, 41, 59])
def test_find_leds_matches_the_parent_on_golden_frames(golden, frame, given):
    """The tracker's call on a golden frame's crop: the areas, threshold and
    tolerances as the parameters' defaults, or as tensors on the device
    (as the tracker passes them, joined on the device)."""
    led = golden["led_pixels"][frame]
    lo, hi = led.min(0) - 15, led.max(0) + 15
    roi = torch.tensor([lo[0], lo[1], hi[0] - lo[0], hi[1] - lo[1]], dtype=torch.float32)
    image = torch.from_numpy(golden["frames"][frame])
    params = BlobParams(min_blob_area=8.0)
    extra = {}
    if given == "tensors":
        extra = {k: torch.tensor(v) for k, v in dict(
            min_area=9.0, max_area=150.0, threshold=230.0, wh_distortion=0.6,
            circ_distortion=0.65).items()}
    calls = dk.detect_epilogue.calls
    got = blob.find_leds(image, roi, params, _golden_camera(golden), **extra)
    want = parent_blob.find_leds(image, roi, params, _golden_camera(golden), **extra)
    assert dk.detect_epilogue.calls == calls + 1
    _same_banks(got, want)
    assert int(got.mask.sum()) == 5


def _frame(case: str, active: bool) -> torch.Tensor:
    frame = np.full((480, 752), 0.0 if active else 255.0, np.float32)
    y, x = AT
    frame[y:y + CROP[0], x:x + CROP[1]] = cases.crop(case, *CROP, active)
    return torch.from_numpy(np.round(frame).astype(np.uint8))


@pytest.mark.parametrize("k", [1, 16, 128])
@pytest.mark.parametrize("option", list(cases.OPTIONS))
@pytest.mark.parametrize("case", cases.CROPS)
def test_epilogue_matches_the_parent_on_crops(case, option, k):
    params = cases.params(option, k, roi_crop=CROP)
    image = _frame(case, params.active_markers)
    roi = torch.tensor([AT[1] + 4.0, AT[0] + 4.0, CROP[1] - 8.0, CROP[0] - 8.0])
    calls = dk.detect_epilogue.calls
    got = blob.find_leds(image, roi, params, cases.camera())
    want = parent_blob.find_leds(image, roi, params, cases.camera())
    assert dk.detect_epilogue.calls == calls + 1  # the crop path
    _same_banks(got, want)
    found = int(got.mask.sum())
    assert found == 0 if case == "empty" else found <= k


def test_the_crops_reach_every_branch():
    """The merged crop splits on its dips, its bars only without the dip
    test, and passive markers split as active ones."""
    def areas(case, option):
        params = cases.params(option, 16, roi_crop=CROP)
        roi = torch.tensor([AT[1] + 4.0, AT[0] + 4.0, CROP[1] - 8.0, CROP[0] - 8.0])
        det = blob.find_leds(_frame(case, params.active_markers), roi, params, cases.camera())
        return sorted(det.area[det.mask].tolist())

    merged = areas("merged", "split-dip-active")
    assert len(merged) >= 7 and len(areas("merged", "nosplit-dip-active")) == 1, merged
    assert areas("merged", "split-dip-passive") == merged
    assert len(areas("elongated", "split-dip-active")) < len(areas("elongated",
                                                                   "split-nodip-active"))
    assert len(areas("touching", "split-dip-active")) >= 2


def _inputs(k=16, h=32, w=40, device="cpu"):
    img = torch.from_numpy(cases.crop("merged", h, w, True))
    prm = cases.epilogue_params([0.0, 0.0, float(w), float(h)], 240.0, 0.7, 0.7, (5.0, 7.0),
                                "cpu")
    lab, maps, top = dk.detect_stats(img, prm[:12], 5, True, 12, k)
    cam = cases.camera()
    return [t.to(device) for t in (lab, maps, top, img, prm)], cam.to(device)


@pytest.mark.parametrize("fault", ["img_dtype", "prm_dtype", "camera_dtype", "dist_shape",
                                   "prm_length", "device"])
def test_wrapper_rejects_bad_input(fault):
    """What the caller hands in is checked; kernel A's outputs are not."""
    (lab, maps, top, img, prm), cam = _inputs()
    if fault == "img_dtype":
        img = img.double()
    elif fault == "prm_dtype":
        prm = prm.double()
    elif fault == "camera_dtype":
        cam = Camera(cam.fx.double(), cam.fy, cam.cx, cam.cy, cam.dist)
    elif fault == "dist_shape":
        cam = Camera(cam.fx, cam.fy, cam.cx, cam.cy, cam.dist[:4])
    elif fault == "prm_length":
        prm = prm[:-1]
    else:
        prm = prm.to("meta")
    with pytest.raises(ValueError, match="detect_epilogue"):
        dk.detect_epilogue(lab, maps, top, img, prm, 5, BlobParams(), cam)


@pytest.mark.parametrize("k", [0, 129])
def test_k_beyond_kernel_a_raises_off_the_cpu(k):
    """K outside 1..min(128, pixels) raises before any launch (tensors on
    the meta device stand in for the card's)."""
    h, w = 32, 40
    meta = lambda shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta")
    cam = Camera(*(meta(()) for _ in range(4)), meta((5,)))
    launches = dk.detect_epilogue.launches
    with pytest.raises(ValueError, match=r"1 <= K <= min\(128, pixels\)"):
        dk.detect_epilogue(meta((h, w), torch.int32), meta((dk.N_MAPS, h, w)),
                           meta((k,), torch.int64), meta((h, w)), meta((16,)), 5, BlobParams(),
                           cam)
    assert dk.detect_epilogue.launches == launches


def test_wrapper_counts_and_launches_once(monkeypatch):
    """A CPU call is a call and no launch; a call on the card (the library
    stood in for) is one launch with the options as flags."""
    seen = []

    class Lib:
        def pfmpe_detect_epilogue(self, *args):
            seen.append(args)
            return 0

    (lab, maps, top, img, prm), cam = _inputs(k=5)
    calls, launches = dk.detect_epilogue.calls, dk.detect_epilogue.launches
    out = dk.detect_epilogue(lab, maps, top, img, prm, 5, BlobParams(), cam)
    assert (dk.detect_epilogue.calls, dk.detect_epilogue.launches) == (calls + 1, launches)
    assert [tuple(t.shape) for t in out] == [(5, 2), (5, 2), (5,), (5,), (5,)]

    monkeypatch.setattr(cuda_lib, "require_cuda", lambda *a: None)
    monkeypatch.setattr(cuda_lib, "library", lambda *a: Lib())
    monkeypatch.setattr(cuda_lib, "stream_ptr", lambda t: 0)
    (lab, maps, top, img, prm), cam = _inputs(k=5, device="meta")
    params = BlobParams(split_dip_ratio=2e6, active_markers=False)
    out = dk.detect_epilogue(lab, maps, top, img, prm, 5, params, cam)
    assert (dk.detect_epilogue.calls, dk.detect_epilogue.launches) == (calls + 2, launches + 1)
    (args,) = seen
    assert args[4:7] == (32, 40, 5) and args[8:10] == (5, 1)  # h, w, K; ntaps, split alone
    assert args[10:13] == (2.5, 1.5, 2e6)
    assert [tuple(t.shape) for t in out] == [(5, 2), (5, 2), (5,), (5,), (5,)]
    assert [t.dtype for t in out] == [torch.float32] * 2 + [torch.bool, torch.float32,
                                                            torch.bool]


def test_full_frame_path_takes_no_epilogue():
    params = cases.params("split-dip-active", 16, roi_crop=CROP)
    calls = dk.detect_epilogue.calls
    image = _frame("merged", True)
    roi = torch.tensor([0.0, 0.0, 752.0, 480.0])
    got = blob.find_leds(image, roi, params, cases.camera())
    want = parent_blob.find_leds(image, roi, params, cases.camera())
    assert dk.detect_epilogue.calls == calls
    _same_banks(got, want)
