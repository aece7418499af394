"""Deterministic, key-driven fault injection (port of `ops/faults.py`).

The reference's robustness mechanism (`number_of_occlusions` /
`number_of_false_detections`): occlude true detections and fabricate
spurious ones near real ones, every pattern replayable from the key.  The
draws are bit-identical to the reference's (`utils/prng.py`), its stable
argsorts are stable sorts here, and its static loops over the counts are
tensor writes at device indices: no value is read back to the host.
"""

from __future__ import annotations

import torch

from ..utils import prng
from ..utils.sync import upload
from .blob import Detections


def _argsort_stable(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, stable=True).indices


def _at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`x[idx]` for a 0-d device index, without a host read."""
    return x.index_select(0, idx.reshape(1))[0]


def inject_faults(key, detections: Detections, num_occlusions: int, num_false_detections: int,
                  false_offset_max: float = 5.0) -> Detections:
    """Occlude up to `num_occlusions` true detections (each on a coin flip)
    and fabricate `num_false_detections` blobs offset by 1 to
    `false_offset_max` px from random real ones, in free slots of the
    fixed-capacity bank (capacity permitting).  Zero for both returns the
    input unchanged.  `key` is a pair of threefry words."""
    if num_occlusions == 0 and num_false_detections == 0:
        return detections
    k_cap = detections.mask.shape[0]
    dev = detections.mask.device
    key_occ, key_coin, key_pick, key_off = prng.split(key, 4)
    slots = torch.arange(k_cap, device=dev)

    mask = detections.mask
    occluded = detections.occluded
    n_true = torch.sum(mask.to(torch.int32))

    if num_occlusions > 0:
        # random priorities over the true detections; the first
        # `num_occlusions` of them are the candidates, distinct by construction
        prio = upload(prng.uniform(key_occ, (k_cap,)), dev)  # hashed on the host, as below
        prio = torch.where(mask, prio, torch.full((), -1.0, device=dev))
        order = _argsort_stable(-prio)
        coins = prng.bernoulli(key_coin, 0.5, (num_occlusions,), device=dev)
        # the reference's candidates past the capacity repeat the last slot
        # and can never be taken (i >= k_cap >= n_true)
        n = min(num_occlusions, k_cap)
        take = coins[:n] & (torch.arange(n, device=dev) < n_true)
        hit = torch.zeros(k_cap, dtype=torch.bool, device=dev).scatter(0, order[:n], take)
        mask = mask & ~hit
        occluded = occluded | hit

    injected = detections.injected
    xy, xy_d, area = detections.xy, detections.xy_distorted, detections.area
    if num_false_detections > 0:
        nf = num_false_detections
        base_n = torch.clamp(torch.sum(mask.to(torch.int32)), min=1)
        picks = prng.randint(key_pick, (nf,), 0, base_n, device=dev)
        src_idx = _argsort_stable(~mask)[picks.long()]  # the i-th currently valid slot
        sign = prng.rademacher(key_off, (nf, 2), device=dev).to(torch.float32)
        mag = prng.randint(prng.fold_in(key_off, 1), (nf, 2), 1, int(false_offset_max) + 1,
                           device=dev)
        offsets = sign * mag.to(torch.float32)
        # free slots first; occluded slots keep their coordinates
        free_order = _argsort_stable(mask | injected | occluded)
        any_true = torch.any(detections.mask)
        # the reference's writes past the capacity land on a slot it has
        # just filled, so they change nothing.  A source slot can be one an
        # earlier write filled (when every true detection was occluded), so
        # the writes stay in order.
        for i in range(min(nf, k_cap)):
            at = slots == free_order[i]
            can = ~torch.any(at & (mask | injected)) & any_true
            put = at & can
            src = src_idx[i]
            xy_d = torch.where(put[:, None], _at(xy_d, src) + offsets[i], xy_d)
            xy = torch.where(put[:, None], _at(xy, src) + offsets[i], xy)
            area = torch.where(put, _at(area, src), area)
            mask = mask | put
            injected = injected | put

    return Detections(xy=xy, xy_distorted=xy_d, mask=mask, area=area, occluded=occluded,
                      injected=injected)
