"""Immutable model snapshots for the RSU serving tier — `ModelStore`.

Counterpart of `repro.serve.store` (`Snapshot`, `ModelStore`). The store
is the boundary between the learner (``run(scenario, publish=
store.publish)``) and the distribution actor (serve/server.py). Each
publication becomes an immutable `Snapshot` holding

  tree            the exact ``FLState.global_tree`` as published;
  served_tree     what a vehicle holds after decoding the snapshot —
                  ``tree`` itself for lossless codecs, the server-side
                  reconstruction for lossy ones;
  delta_payload   ``encode_snapshot(codec, tree, prev.served_tree)``,
                  encoded ONCE at publish time;
  full payload    identity framing of ``served_tree``, built lazily on
                  the first stale fetch and cached.

Lossy codecs chain off the reconstruction: a delta_int8 snapshot
encodes θ_r against the previous *served* tree θ̂_{r-1}, and every
vehicle that applies the same payloads runs the same deterministic
decode on the same inputs, so its tree is bitwise ``served_tree``
whichever way it arrived.

Publishes come from ONE learner (rounds strictly increasing); fetch-side
reads are thread-safe against a concurrent publish. Retention is bounded
by ``window``; eviction breaks the delta chain and `chain_from` answers
None, which the server turns into the full-tree fallback.

Host bookkeeping over device tensors: the trees and payloads stay on the
device they were published on; nothing here copies one to the host.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.comms.codecs import (CODECS, decode_snapshot,
                                      encode_snapshot, payload_nbytes)

__all__ = ["ModelStore", "Snapshot"]


@dataclass
class Snapshot:
    """One published (round, codec, payload) model snapshot. Immutable
    once published, except the lazily built full-payload cache
    (`ModelStore.full_payload` guards it with the store lock)."""

    round: int
    base_round: Optional[int]        # published round the delta chains from
    tree: Any                        # the exact published global model
    served_tree: Any                 # the vehicle-side reconstruction
    delta_payload: Optional[dict]    # encoded once; None for the first snap
    _full: Optional[dict] = field(default=None, repr=False)

    @property
    def delta_nbytes(self) -> Optional[int]:
        return (None if self.delta_payload is None
                else payload_nbytes(self.delta_payload))


class ModelStore:
    """Round-indexed snapshot store.

    codec    `CODECS` name framing the delta payloads (default the
             lossless ``delta``)
    window   how many snapshots stay fetchable; older ones are evicted
             and very stale vehicles fall back to the full tree
    """

    def __init__(self, codec: str = "delta", window: int = 8):
        if codec not in CODECS:
            raise ValueError(f"unknown codec {codec!r}; valid: "
                             f"{sorted(CODECS)}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.codec = codec
        self.window = window
        self._lock = threading.Lock()
        self._snaps: "OrderedDict[int, Snapshot]" = OrderedDict()
        self._stats = {"publishes": 0, "delta_encodes": 0, "full_encodes": 0}

    # -- publish (the learner side) -----------------------------------------

    def publish(self, rnd: int, tree) -> Snapshot:
        """Ingest the new global model for round ``rnd`` — the target of
        the ``run(publish=store.publish)`` hook. Encodes the delta payload
        ONCE, outside the lock, so fetches keep flowing meanwhile."""
        rnd = int(rnd)
        with self._lock:
            prev = (next(reversed(self._snaps.values()))
                    if self._snaps else None)
        if prev is not None and rnd <= prev.round:
            raise ValueError(f"publish rounds must increase: got {rnd} "
                             f"after {prev.round}")
        codec = CODECS[self.codec]
        if prev is None:
            payload, served, base_round = None, tree, None
        else:
            payload = encode_snapshot(codec, tree, prev.served_tree)
            served = (tree if codec.lossless
                      else decode_snapshot(codec, payload, prev.served_tree))
            base_round = prev.round
        snap = Snapshot(round=rnd, base_round=base_round, tree=tree,
                        served_tree=served, delta_payload=payload)
        with self._lock:
            self._snaps[rnd] = snap
            self._stats["publishes"] += 1
            if payload is not None:
                self._stats["delta_encodes"] += 1
            while len(self._snaps) > self.window:
                self._snaps.popitem(last=False)
        return snap

    # -- fetch-side reads ----------------------------------------------------

    @property
    def latest_round(self) -> Optional[int]:
        with self._lock:
            return next(reversed(self._snaps)) if self._snaps else None

    def latest(self) -> Optional[Snapshot]:
        with self._lock:
            return (next(reversed(self._snaps.values()))
                    if self._snaps else None)

    def get(self, rnd: int) -> Optional[Snapshot]:
        with self._lock:
            return self._snaps.get(rnd)

    def rounds(self) -> List[int]:
        with self._lock:
            return list(self._snaps)

    def chain_from(self, have_round: int) -> Optional[List[Snapshot]]:
        """The delta chain a vehicle holding published round
        ``have_round`` applies to reach the latest snapshot, in
        application order. Empty list = up to date. None = no valid chain
        (broken by eviction, or the round was never a chain base): serve
        the full tree instead."""
        with self._lock:
            newer = [s for r, s in self._snaps.items() if r > have_round]
        prev = have_round
        for s in newer:
            if s.base_round != prev or s.delta_payload is None:
                return None
            prev = s.round
        return newer

    def full_payload(self, rnd: int) -> dict:
        """Identity-framed full tree for round ``rnd`` — the staleness
        fallback payload, encoded ONCE on the first request and cached."""
        with self._lock:
            snap = self._snaps.get(rnd)
            if snap is None:
                raise KeyError(f"round {rnd} is not retained "
                               f"(have: {list(self._snaps)})")
            if snap._full is None:
                snap._full = encode_snapshot("identity", snap.served_tree,
                                             None)
                self._stats["full_encodes"] += 1
            return snap._full

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._stats)
