"""Device <-> host copies, counted.

The reference runs its whole frame as one compiled program with
`lax.cond` / `lax.while_loop`; the port turns those into host control
flow, and every value the host branches on is a device -> host copy (a
stream synchronisation on CUDA).  Code that branches takes a `HostReads`
and reads through it, so the tracker can report its syncs per frame.

The other way, each host value a frame puts on the device (a Python
number, a list, a numpy array) is a copy from pageable memory, which
PyTorch ends with a stream synchronisation on CUDA.  The tracker makes
them through `HostReads.put`; the helpers below it, which take no
`HostReads`, through `upload`, which counts them on the `HostReads`
entered last (`with host:`; the tracker enters its own for each frame).
A tensor already on the device is no copy and is not counted.
"""

from __future__ import annotations

import torch

_ACTIVE: list["HostReads"] = []  # the HostReads of the frame step that runs, innermost last


class HostReads:
    """Callable that copies a tensor to a host list and counts the copy
    (`count`); `put` counts the copies the other way (`uploads`)."""

    def __init__(self) -> None:
        self.count = 0
        self.uploads = 0

    def __call__(self, t: torch.Tensor):
        self.count += 1
        return t.detach().cpu().tolist()

    def put(self, v, device, dtype=torch.float32) -> torch.Tensor:
        """`v` as a `dtype` tensor on `device`: one upload when `v` is a host
        value (number, list, array; so a CPU tracker counts what the card
        copies) or a tensor on another device."""
        out = torch.as_tensor(v, dtype=dtype).to(device)
        if not torch.is_tensor(v) or v.device != out.device:
            self.uploads += 1
        return out

    def __enter__(self) -> "HostReads":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.pop()


def upload(v, device, dtype=torch.float32) -> torch.Tensor:
    """`v` as a `dtype` tensor on `device`, through the innermost active
    `HostReads` (counted) or, outside any, uncounted."""
    if _ACTIVE:
        return _ACTIVE[-1].put(v, device, dtype)
    return torch.as_tensor(v, dtype=dtype).to(device)
