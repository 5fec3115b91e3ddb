"""`CohortBatch` — a round's trained cohort as one flat buffer.

Counterpart of `repro.core.cohort` (`bucket_size`; `CohortBatch`:
`empty`, `write`, `concat`, `take`, `with_stats`, `padded_weights`,
`pad_to`, `sharding_spec`, `shard`, `gather`; and the reference's tree
views, which the rounds never call: `from_stacked`, `from_list`,
`valid_trees`, `unstack`, `valid_velocities`). The reference stacks
each leaf of the client trees along a leading cohort axis and ravels the
stack into an (m, P) matrix at the aggregation boundary
(`ops.wagg_stacked`). The port keeps the cohort in that matrix from the
start: each client's trained tree is written into its row, in the flat
row layout of convert.py (`write`; `write_rows` for a chunk of clients
trained as one batch), so aggregation reads the buffer as it is.

  flat        (m, P) float32, row i = client i's raveled tree
  spec        where each leaf lives in a row (convert.FlatSpec)
  losses      (m,) per-client mean local loss
  mask        (m,) float32 validity: 1.0 for real clients, 0.0 padding
  n           count of valid clients; valid rows are the prefix [0, n)
  velocities  (m,) per-client velocities (attached by the topology)
  blur        (m,) Eq.-2 blur levels (attached by the topology)
  mesh, row0  a SHARDED cohort (`shard`): the cohort mesh, and the first
              row of this rank's block; `flat` then holds only that block
              of the (m, P) rows, while losses, mask, n and the stats stay
              the whole cohort's (small, the same on every rank)

Padding rows (m > n) get weight 0 and mask 0, so the masked aggregation
(fmaf(0, x, acc) == acc for finite x) is bitwise equal to the unpadded
one. `empty` allocates them as zeros; the batched client step of a
bucketed cohort writes them with the trained rows of the padded inputs
(the last client's batch and draws again), and `pad_to` repeats the last
row.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.convert import (FlatSpec, flat_spec, leaves_with_paths,
                                 ravel_into, tree_map, unflatten, unravel)
from repro_torch.core.collectives import (all_gather_rows, axis_size,
                                          cohort_rank)


def bucket_size(n: int) -> int:
    """Smallest power of two >= n: the padded size of a handover
    download group under ``bucketed=True`` (as the reference pads)."""
    if n < 1:
        raise ValueError(f"cohort size must be >= 1, got {n}")
    m = 1
    while m < n:
        m *= 2
    return m


@dataclass(frozen=True)
class CohortBatch:
    flat: torch.Tensor
    spec: FlatSpec
    losses: torch.Tensor
    mask: torch.Tensor
    n: int
    velocities: Optional[torch.Tensor] = None
    blur: Optional[torch.Tensor] = None
    mesh: Any = None
    row0: int = 0

    @classmethod
    def empty(cls, spec: FlatSpec, m: int, n: Optional[int] = None,
              device="cpu") -> "CohortBatch":
        """An (m, P) buffer for m rows, n of them valid (default m); the
        m - n padding rows are zero."""
        n = m if n is None else int(n)
        if not 1 <= n <= m:
            raise ValueError(f"valid count {n} not in [1, {m}]")
        flat = torch.empty((m, spec.size), dtype=torch.float32, device=device)
        flat[n:].zero_()
        return cls(flat=flat, spec=spec,
                   losses=torch.zeros(m, dtype=torch.float32, device=device),
                   mask=(torch.arange(m, device=device) < n).float(), n=n)

    @classmethod
    def from_stacked(cls, trees, losses, n: Optional[int] = None,
                     **stats) -> "CohortBatch":
        """The cohort of already-stacked trees (each leaf (m, ...), row i
        client i's); rows [n, m) are padding, written as given and masked
        out. The stats are kept as given."""
        losses = torch.as_tensor(losses, dtype=torch.float32)
        m = int(losses.shape[0])
        spec = flat_spec(tree_map(lambda x: x[0], trees))
        c = cls.empty(spec, m, n=n, device=losses.device)
        c.write_rows(0, trees, losses)
        return dataclasses.replace(c, **stats)

    @classmethod
    def from_list(cls, trees, losses, **stats) -> "CohortBatch":
        """The cohort of a list of per-client trees (stacked leaf by leaf
        in the flat row layout's order), every row valid."""
        stacked = unflatten(
            [torch.stack(ls) for ls in zip(*(
                [leaf for _, leaf in leaves_with_paths(t)] for t in trees))],
            trees[0])
        if isinstance(losses, (list, tuple)):
            losses = torch.stack([torch.as_tensor(v) for v in losses])
        return cls.from_stacked(stacked, losses, n=len(trees), **stats)

    @classmethod
    def concat(cls, cohorts) -> "CohortBatch":
        """The VALID rows of several cohorts, in order, as one cohort
        (padding dropped); velocities and blur are kept when every input
        has them."""
        stats = {}
        for f in ("velocities", "blur"):
            vals = [getattr(c, f) for c in cohorts]
            if all(v is not None for v in vals):
                stats[f] = torch.cat([v[:c.n] for v, c in zip(vals, cohorts)])
        flat = torch.cat([c.flat[:c.n] for c in cohorts])
        losses = torch.cat([c.valid_losses for c in cohorts])
        return cls(flat=flat, spec=cohorts[0].spec, losses=losses,
                   mask=torch.ones_like(losses), n=int(flat.shape[0]),
                   **stats)

    def take(self, idx) -> "CohortBatch":
        """A sub-cohort gathered from the valid rows, in `idx` order."""
        idx = torch.as_tensor(idx, dtype=torch.long, device=self.flat.device)

        def pick(x):
            return None if x is None else x[:self.n][idx]

        losses = pick(self.losses)
        return CohortBatch(flat=pick(self.flat), spec=self.spec,
                           losses=losses, mask=torch.ones_like(losses),
                           n=int(losses.shape[0]),
                           velocities=pick(self.velocities),
                           blur=pick(self.blur))

    def write(self, i: int, tree, loss) -> None:
        """Ravel client i's trained tree into row i (in place)."""
        ravel_into(tree, self.flat[i], self.spec)
        self.losses[i] = loss

    def write_rows(self, i0: int, trees, losses) -> None:
        """Write a chunk of c clients at once (in place): `trees` holds
        each leaf stacked along a leading axis of c, client j's tree going
        into row i0 + j; `losses` is (c,). One copy a leaf."""
        c = int(losses.shape[0])
        rows = self.flat[i0:i0 + c]
        for (_, _, off, n), (_, leaf) in zip(self.spec.entries,
                                             leaves_with_paths(trees)):
            rows[:, off:off + n].copy_(leaf.reshape(c, n))
        self.losses[i0:i0 + c] = losses

    @property
    def size(self) -> int:
        return int(self.mask.shape[0])

    @property
    def valid_losses(self):
        return self.losses[:self.n]

    @property
    def valid_trees(self) -> dict:
        """The n valid rows as one stacked tree (each leaf (n, ...)),
        views into the buffer."""
        self._check_whole("valid_trees")
        return unravel(self.flat[:self.n], self.spec)

    def unstack(self) -> list:
        """The n valid clients' trees, a list of views into the buffer."""
        self._check_whole("unstack")
        return [unravel(self.flat[i], self.spec) for i in range(self.n)]

    def _check_whole(self, what: str) -> None:
        if self.mesh is not None:
            raise ValueError(f"{what} reads every row, and this cohort is "
                             f"sharded (this rank holds one block); "
                             f"gather() it first")

    @property
    def valid_velocities(self):
        if self.velocities is None:
            raise ValueError("cohort has no velocities attached; the "
                             "topology must call with_stats() first")
        return self.velocities[:self.n]

    @property
    def valid_blur(self):
        if self.blur is None:
            raise ValueError("cohort has no blur levels attached; the "
                             "topology must call with_stats() first")
        return self.blur[:self.n]

    def with_stats(self, velocities=None, blur=None) -> "CohortBatch":
        """Attach per-client velocities/blur, padded to the cohort size by
        replicating the last value."""
        def pad(x, cur):
            if x is None:
                return cur
            x = torch.as_tensor(x, dtype=torch.float32,
                                device=self.flat.device)
            if x.shape[0] == self.size:
                return x
            if x.shape[0] != self.n:
                raise ValueError(f"stat length {x.shape[0]} matches "
                                 f"neither n={self.n} nor m={self.size}")
            return torch.cat([x, x[-1:].expand(self.size - self.n)])

        return dataclasses.replace(self, velocities=pad(velocities,
                                                        self.velocities),
                                   blur=pad(blur, self.blur))

    def pad_to(self, m: int) -> "CohortBatch":
        """The cohort re-padded to m rows: the last row of the buffer,
        the losses and the stats repeated (finite values, no RNG), the
        mask still the valid prefix [0, n); so every masked aggregation
        is bitwise the unpadded one's."""
        if m < self.size:
            raise ValueError(f"pad_to({m}) smaller than the current size "
                             f"{self.size}")
        if m == self.size:
            return self
        pad = m - self.size

        def ext(x):
            if x is None:
                return None
            return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])

        return CohortBatch(
            flat=ext(self.flat), spec=self.spec, losses=ext(self.losses),
            mask=(torch.arange(m, device=self.flat.device) < self.n).float(),
            n=self.n, velocities=ext(self.velocities), blur=ext(self.blur))

    @staticmethod
    def sharding_spec(mesh, size: int) -> slice:
        """This rank's block of a cohort of `size` rows sharded over
        `mesh`: the rows of the cohort padded to a multiple of the mesh's
        ranks, split into equal contiguous blocks in rank order."""
        ext = axis_size(mesh)
        b = -(-size // ext)
        r = cohort_rank(mesh)
        return slice(r * b, (r + 1) * b)

    def shard(self, mesh) -> "CohortBatch":
        """This rank's block of the cohort on `mesh` (see the module
        docstring). Pads to a multiple of the mesh's ranks first (the last
        row repeated, masked out), so a cohort smaller than the mesh still
        shards; some ranks then hold only padding rows."""
        ext = axis_size(mesh)
        c = self.pad_to(-(-self.size // ext) * ext)
        blk = self.sharding_spec(mesh, c.size)
        return dataclasses.replace(c, flat=c.flat[blk].clone(), mesh=mesh,
                                   row0=blk.start)

    def gather(self) -> "CohortBatch":
        """Undo `shard`: every rank's block gathered back (an all_gather
        over the mesh), the whole cohort on every rank."""
        if self.mesh is None:
            return self
        return dataclasses.replace(self, flat=all_gather_rows(self.flat),
                                   mesh=None, row0=0)

    def padded_weights(self, w_valid) -> torch.Tensor:
        """(n,) weights over the valid rows -> (m,) with zero padding."""
        w = torch.as_tensor(w_valid, dtype=torch.float32,
                            device=self.flat.device).reshape(-1)
        if w.shape[0] != self.n:
            raise ValueError(f"got {w.shape[0]} weights for {self.n} "
                             f"valid clients")
        if self.size == self.n:
            return w
        return torch.cat([w, w.new_zeros(self.size - self.n)])
