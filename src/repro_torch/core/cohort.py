"""`CohortBatch` — a round's trained cohort as one flat buffer.

Counterpart of `repro.core.cohort.CohortBatch` (`empty`, `write`,
`concat`, `take`, `with_stats`, `padded_weights`). The reference stacks
each leaf of the client trees along a leading cohort axis and ravels the
stack into an (m, P) matrix at the aggregation boundary
(`ops.wagg_stacked`). The port keeps the cohort in that matrix from the
start: each client's trained tree is written into its row, in the flat
row layout of convert.py, so aggregation reads the buffer as it is.

  flat        (m, P) float32, row i = client i's raveled tree
  spec        where each leaf lives in a row (convert.FlatSpec)
  losses      (m,) per-client mean local loss
  mask        (m,) float32 validity: 1.0 for real clients, 0.0 padding
  n           count of valid clients; valid rows are the prefix [0, n)
  velocities  (m,) per-client velocities (attached by the topology)
  blur        (m,) Eq.-2 blur levels (attached by the topology)

Padding rows (m > n) are allocated as zeros and get weight 0, so the
masked aggregation (fmaf(0, 0, acc) == acc) is bitwise equal to the
unpadded one.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.convert import FlatSpec, ravel_into


@dataclass(frozen=True)
class CohortBatch:
    flat: torch.Tensor
    spec: FlatSpec
    losses: torch.Tensor
    mask: torch.Tensor
    n: int
    velocities: Optional[torch.Tensor] = None
    blur: Optional[torch.Tensor] = None

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

    @property
    def size(self) -> int:
        return int(self.mask.shape[0])

    @property
    def valid_losses(self):
        return self.losses[:self.n]

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
