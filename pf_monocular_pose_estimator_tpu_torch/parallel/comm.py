"""The particles mesh: what `shard_map`, `jax.lax.axis_index`, `all_gather`
and `ppermute` give the reference's sharded code.

A bank of N particles is cut into P shards of S = N / P lanes.  Every
sharded tensor carries the shards this process holds on a leading axis:
weights (L, S), a bank (L, 16, S).  Two meshes give that axis its meaning:

  * `LocalMesh(P)`: all P shards in one process on one device (L = P), the
    counterpart of the reference's virtual CPU devices and what runs on a
    machine with one card.  Collectives are tensor ops on the leading axis.
  * `DistMesh()`: one shard per `torch.distributed` rank (L = 1; `nccl`
    between cards, `gloo` on the CPU).

Shard bodies are written once over the leading axis and serve both.  Every
collective returns the same values on both meshes, so a P-shard local run
and a P-rank distributed run agree bit for bit.
"""

from __future__ import annotations

import torch


class LocalMesh:
    """P shards of one process; shard i is row i of the leading axis."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError("a mesh needs at least one shard")
        self.size = int(size)
        self.ranks = tuple(range(self.size))

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(L, ...) -> (P, ...) in shard order, the same on every rank."""
        return x

    def ppermute(self, x: torch.Tensor, delta: int) -> torch.Tensor:
        """Shard i's rows go to shard (i + delta) mod P."""
        return torch.roll(x, delta, 0) if delta % self.size else x

    def receive(self, x: torch.Tensor, delta: int) -> list[torch.Tensor]:
        """What `ppermute(x, delta)` delivers, one tensor a local shard:
        shard i receives shard (i - delta) mod P's rows, here a view of
        them (no copy)."""
        return [x[(i - delta) % self.size] for i in range(self.size)]

    def broadcast_from(self, x: torch.Tensor, rank: int) -> torch.Tensor:
        """Shard `rank`'s row of x (L, ...) -> (...), on every rank."""
        return x[rank]


class DistMesh:
    """One shard per rank of the default `torch.distributed` process group."""

    def __init__(self):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("DistMesh needs torch.distributed.init_process_group first")
        self._dist = dist
        self.size = dist.get_world_size()
        self.rank = dist.get_rank()
        self.ranks = (self.rank,)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        out = [torch.empty_like(x[0]) for _ in range(self.size)]
        self._dist.all_gather(out, x[0].contiguous())
        return torch.stack(out)

    def ppermute(self, x: torch.Tensor, delta: int) -> torch.Tensor:
        if delta % self.size == 0:
            return x
        dist = self._dist
        send = x.contiguous()
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, (self.rank + delta) % self.size),
               dist.P2POp(dist.irecv, recv, (self.rank - delta) % self.size)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv

    def receive(self, x: torch.Tensor, delta: int) -> list[torch.Tensor]:
        return [self.ppermute(x, delta)[0]]

    def broadcast_from(self, x: torch.Tensor, rank: int) -> torch.Tensor:
        out = x[0].contiguous().clone()
        self._dist.broadcast(out, rank)
        return out


def shard_index(mesh, device) -> torch.Tensor:
    """(L,) int64: which shard each row of the leading axis is
    (`jax.lax.axis_index` per local shard)."""
    return torch.tensor(mesh.ranks, dtype=torch.int64, device=device)


def shard_lanes(mesh, x: torch.Tensor) -> torch.Tensor:
    """(..., N) -> (L, ..., S): this process's shards of the lane axis."""
    n = x.shape[-1]
    if n % mesh.size:
        raise ValueError(f"the lane axis ({n}) must divide over {mesh.size} shards")
    blocks = x.reshape(*x.shape[:-1], mesh.size, n // mesh.size).movedim(-2, 0)
    return blocks[list(mesh.ranks)].contiguous()


def unshard_lanes(mesh, x: torch.Tensor) -> torch.Tensor:
    """(L, ..., S) -> (..., N) on every rank (an all_gather: for tests and
    results, not for the per-frame path)."""
    full = mesh.all_gather(x).movedim(0, -2)
    return full.reshape(*full.shape[:-2], -1)
