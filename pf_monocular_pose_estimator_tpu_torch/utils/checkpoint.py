"""Checkpoint and resume of tracker state (port of `utils/checkpoint.py`).

A state is a dataclass of tensors, so a checkpoint is one `.npz` with a
leaf per field and a record of the structure: the class, and each field's
name, shape and dtype.  Loading checks that record against the state it
is asked to fill and raises on any difference (another state version,
single- against multi-target, another particle count), instead of
reinterpreting leaves.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch


def _structure(state) -> dict:
    return {"class": type(state).__name__,
            "fields": [[f.name, list(getattr(state, f.name).shape),
                        str(getattr(state, f.name).dtype).removeprefix("torch.")]
                       for f in dataclasses.fields(state)]}


def save_state(path: str, state) -> None:
    """Write every field of a single or multi-target `TargetState` to `path`.

    A state sharded over a particles mesh is saved after
    `parallel.unshard_target_state`, as the reference's `save_state` writes
    the global array, so the checkpoint does not depend on the mesh."""
    record = json.dumps(_structure(state)).encode()
    np.savez(path, structure=np.frombuffer(record, dtype=np.uint8),
             **{f"leaf_{f.name}": getattr(state, f.name).detach().cpu().numpy()
                for f in dataclasses.fields(state)})


def load_state(path: str, like):
    """Load a checkpoint into the structure of `like`, each leaf on the
    device and in the dtype of `like`'s; any difference between the stored
    structure and `like`'s raises `ValueError`."""
    with np.load(path) as data:
        if "structure" not in data.files:
            raise ValueError(f"{path}: no structure record: not a checkpoint of this package")
        stored = json.loads(bytes(data["structure"]).decode())
        expected = _structure(like)
        if stored != expected:
            raise ValueError(f"checkpoint structure mismatch:\n  stored: {stored}\n"
                             f"  expected: {expected}")
        leaves = {}
        for f in dataclasses.fields(like):
            ref = getattr(like, f.name)
            leaves[f.name] = torch.from_numpy(data[f"leaf_{f.name}"]).to(device=ref.device,
                                                                        dtype=ref.dtype)
    return type(like)(**leaves)
