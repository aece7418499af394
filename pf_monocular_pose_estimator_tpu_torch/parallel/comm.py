"""The particles mesh: what `shard_map`, `jax.lax.axis_index`, `all_gather`
and `ppermute` give the reference's sharded code.

A bank of N particles is cut into P shards of S = N / P lanes.  Every
sharded tensor carries the shards this process holds on a leading axis:
weights (L, S), a bank (L, 16, S).  Two meshes give that axis its meaning:

  * `LocalMesh(P)`: all P shards in one process on one device (L = P), the
    counterpart of the reference's virtual CPU devices and what runs on a
    machine with one card.  Collectives are tensor ops on the leading axis.
  * `DistMesh(group)`: one shard per rank of a `torch.distributed` group
    (L = 1; `nccl` between cards, `gloo` on the CPU), the whole job when
    `group` is None.

Shard bodies are written once over the leading axis and serve both.  Every
collective returns the same values on both meshes, so a P-shard local run
and a P-rank distributed run agree bit for bit.

A mesh also carries the reference's `targets` axis: `target_shards` groups
of targets, each group a particles mesh of its own.  A local mesh holds
every group; a `DistMesh` is the particles mesh of group `target_index`,
ranks `target_index * P` to `target_index * P + P - 1` of the job
(`parallel.distributed.make_pod_mesh`), and holds that group's targets.
"""

from __future__ import annotations

import torch


class LocalMesh:
    """P shards of one process; shard i is row i of the leading axis."""

    def __init__(self, size: int, target_shards: int = 1):
        if size < 1 or target_shards < 1:
            raise ValueError("a mesh needs at least one shard and one target group")
        self.size = int(size)
        self.ranks = tuple(range(self.size))
        self.target_shards = int(target_shards)

    def owned_targets(self, n_targets: int) -> range:
        """The targets this process holds: all of them."""
        _check_targets(self, n_targets)
        return range(n_targets)

    def gather_targets(self, x: torch.Tensor) -> torch.Tensor:
        """(T_own, ...) -> (T, ...): here every target is local."""
        return x

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
    """One shard per rank of a `torch.distributed` group (the default group
    when `group` is None); `size` and `rank` are taken within the group."""

    def __init__(self, group=None, target_shards: int = 1, target_index: int = 0):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("DistMesh needs torch.distributed.init_process_group first")
        self._dist = dist
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        if self.rank < 0:
            raise ValueError("DistMesh: this process is not a member of the group")
        self.ranks = (self.rank,)
        self.target_shards = int(target_shards)
        self.target_index = int(target_index)
        self._device = torch.device("cuda" if dist.get_backend(group) == "nccl" else "cpu")

    def _global(self, rank: int) -> int:
        """The job's rank of this group's `rank` (point-to-point ops take it)."""
        return rank if self.group is None else self._dist.get_global_rank(self.group, rank)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        out = [torch.empty_like(x[0]) for _ in range(self.size)]
        self._dist.all_gather(out, x[0].contiguous(), group=self.group)
        return torch.stack(out)

    def ppermute(self, x: torch.Tensor, delta: int) -> torch.Tensor:
        if delta % self.size == 0:
            return x
        dist = self._dist
        send = x.contiguous()
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, self._global((self.rank + delta) % self.size),
                          self.group),
               dist.P2POp(dist.irecv, recv, self._global((self.rank - delta) % self.size),
                          self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv

    def receive(self, x: torch.Tensor, delta: int) -> list[torch.Tensor]:
        return [self.ppermute(x, delta)[0]]

    def broadcast_from(self, x: torch.Tensor, rank: int) -> torch.Tensor:
        out = x[0].contiguous().clone()
        self._dist.broadcast(out, self._global(rank), group=self.group)
        return out

    def owned_targets(self, n_targets: int) -> range:
        """The targets this rank's group holds: the `target_index`-th of
        `target_shards` equal blocks."""
        per = _check_targets(self, n_targets)
        return range(self.target_index * per, (self.target_index + 1) * per)

    def gather_targets(self, x: torch.Tensor) -> torch.Tensor:
        """(T_own, ...), the same on every rank of a group -> (T, ...) on
        every rank of the job: one all_gather over the whole job, of which
        each group's first rank gives its block."""
        y = x.to(self._device, torch.uint8 if x.dtype == torch.bool else x.dtype).contiguous()
        out = [torch.empty_like(y) for _ in range(self._dist.get_world_size())]
        self._dist.all_gather(out, y)
        return torch.cat(out[::self.size]).to(x.device, x.dtype)


def _check_targets(mesh, n_targets: int) -> int:
    if n_targets % mesh.target_shards:
        raise ValueError(f"{n_targets} targets do not divide over {mesh.target_shards} target "
                         "groups")
    return n_targets // mesh.target_shards


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
