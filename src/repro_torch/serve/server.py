"""Batched RSU model distribution with admission control — `RSUServer`.

Counterpart of `repro.serve.server` (`ServePolicy`, `Reply`,
`PendingFetch`, `build_reply`, `apply_reply`, `RSUServer`). Vehicles call
``submit(have_round)`` and get a `PendingFetch`; a batcher drains the
bounded request queue in batches of at most ``max_batch`` requests,
groups each batch by the round the vehicle already holds, and builds ONE
reply per group. Replies are:

  kind="current"  the vehicle already holds the latest published round;
  kind="delta"    the delta payload chain from the held round to the
                  latest snapshot (``<= max_lag`` hops);
  kind="full"     the staleness fallback: the full served tree;
  status="shed"   admission control: the bounded queue was full (or the
                  server stopped); the reply carries ``retry_after_s``.

Every submit resolves exactly once, as a payload or as a shed. The
batcher is the internal daemon thread (``start=True``) or driven by hand
with ``drain_once(block=False)``, the deterministic mode. Reply building
is host bookkeeping over payloads already on the device; decoding
(`apply_reply`) runs on the vehicle's side.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

from repro_torch.comms.codecs import decode_snapshot
from repro_torch.serve.store import ModelStore

__all__ = ["PendingFetch", "Reply", "RSUServer", "ServePolicy",
           "apply_reply", "build_reply"]


@dataclass(frozen=True)
class ServePolicy:
    """Batching and admission-control knobs for one `RSUServer`.

    max_batch      requests answered per drain (coalescing bound)
    max_wait_s     how long a non-full batch waits for more requests
    queue_limit    submits beyond this many queued requests are shed
    max_lag        a vehicle more than this many published hops behind
                   gets the full tree, not a delta chain
    retry_after_s  backpressure hint carried by shed replies
    """

    max_batch: int = 256
    max_wait_s: float = 0.001
    queue_limit: int = 4096
    max_lag: int = 4
    retry_after_s: float = 0.05

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, "
                             f"got {self.queue_limit}")
        if self.max_lag < 0:
            raise ValueError(f"max_lag must be >= 0, got {self.max_lag}")


@dataclass(frozen=True)
class Reply:
    """One fetch outcome. ``payloads`` is ``((round, payload), ...)`` in
    application order; `apply_reply` folds it into the vehicle's tree."""

    status: str                  # "ok" | "shed"
    round: int = -1              # round the payloads bring the vehicle to
    kind: str = ""               # "current" | "delta" | "full"
    base_round: int = -1         # delta chains apply on top of this round
    payloads: tuple = ()
    retry_after_s: float = 0.0


class PendingFetch:
    """Future-like handle for one submitted fetch; resolves exactly once
    (a second resolution raises)."""

    __slots__ = ("have_round", "t_submit", "_event", "_reply")

    def __init__(self, have_round: int):
        self.have_round = int(have_round)
        self.t_submit = time.perf_counter()
        self._event = threading.Event()
        self._reply: Optional[Reply] = None

    def _resolve(self, reply: Reply) -> None:
        if self._event.is_set():
            raise RuntimeError("fetch answered twice")
        self._reply = reply
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Reply:
        if not self._event.wait(timeout):
            raise TimeoutError(f"no reply within {timeout}s")
        return self._reply


def build_reply(store: ModelStore, policy: ServePolicy,
                have_round: int) -> Reply:
    """The one reply for every coalesced request holding ``have_round``:
    a delta chain when linked and within ``max_lag`` hops, the full tree
    when stale or unlinked, "current" when already at the latest round.
    An empty store answers shed-with-retry."""
    chain = store.chain_from(have_round)
    if chain and len(chain) <= policy.max_lag:
        return Reply(status="ok", round=chain[-1].round, kind="delta",
                     base_round=have_round,
                     payloads=tuple((s.round, s.delta_payload)
                                    for s in chain))
    latest = store.latest()
    if latest is None:
        return Reply(status="shed", retry_after_s=policy.retry_after_s)
    if have_round >= latest.round:
        return Reply(status="ok", round=latest.round, kind="current",
                     base_round=latest.round)
    return Reply(status="ok", round=latest.round, kind="full",
                 payloads=((latest.round,
                            store.full_payload(latest.round)),))


def apply_reply(reply: Reply, have_tree, codec="delta"):
    """Vehicle-side decode: fold a Reply into the locally held model.
    Full payloads replace the tree; delta payloads chain on top of it
    (each hop's output is the next hop's base); "current" keeps it."""
    if reply.status != "ok":
        raise ValueError(f"cannot apply a {reply.status!r} reply; retry "
                         f"after {reply.retry_after_s}s")
    if reply.kind == "current":
        return have_tree
    if reply.kind == "full":
        ((_rnd, payload),) = reply.payloads
        return decode_snapshot("identity", payload, None)
    tree = have_tree
    for _rnd, payload in reply.payloads:
        tree = decode_snapshot(codec, payload, tree)
    return tree


class RSUServer:
    """Bounded-queue, batching model-distribution server over one
    `ModelStore`. ``start=True`` runs the batcher as a daemon thread;
    ``start=False`` leaves draining to the caller."""

    def __init__(self, store: ModelStore, policy: Optional[ServePolicy] = None,
                 start: bool = True):
        self.store = store
        self.policy = policy or ServePolicy()
        self._cv = threading.Condition()
        self._queue: "deque[PendingFetch]" = deque()
        self._stats = {"submitted": 0, "served": 0, "shed": 0,
                       "batches": 0, "groups": 0, "max_depth": 0}
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._thread = threading.Thread(target=self._serve_loop,
                                        name="rsu-serve", daemon=True)
        self._thread.start()

    def stop(self, drain: bool = True) -> None:
        """Stop accepting requests and answer everything still queued —
        served (``drain=True``) or shed with retry-after (``False``)."""
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            if self._thread.is_alive():
                raise RuntimeError("serve thread did not stop within 30 s")
            self._thread = None
        if drain:
            while self.drain_once(block=False):
                pass
        else:
            with self._cv:
                leftovers = list(self._queue)
                self._queue.clear()
                self._stats["shed"] += len(leftovers)
            shed = Reply(status="shed",
                         retry_after_s=self.policy.retry_after_s)
            for req in leftovers:
                req._resolve(shed)

    # -- vehicle side --------------------------------------------------------

    def submit(self, have_round: int) -> PendingFetch:
        """Enqueue one fetch. Admission control happens here: if the
        bounded queue is full (or the server is stopped), the returned
        handle is already resolved as a shed reply with a retry-after."""
        req = PendingFetch(have_round)
        shed = None
        with self._cv:
            self._stats["submitted"] += 1
            if self._stopped or len(self._queue) >= self.policy.queue_limit:
                self._stats["shed"] += 1
                shed = Reply(status="shed",
                             retry_after_s=self.policy.retry_after_s)
            else:
                self._queue.append(req)
                self._stats["max_depth"] = max(self._stats["max_depth"],
                                               len(self._queue))
                self._cv.notify()
        if shed is not None:
            req._resolve(shed)
        return req

    @property
    def pending(self) -> int:
        with self._cv:
            return len(self._queue)

    def stats(self) -> dict:
        with self._cv:
            return dict(self._stats)

    # -- batcher -------------------------------------------------------------

    def _collect(self, block: bool, timeout: Optional[float]) -> list:
        """Pop up to ``max_batch`` requests; in blocking mode a non-full
        batch waits ``max_wait_s`` for more (the coalescing window)."""
        wait_more = self.policy.max_wait_s if block else 0.0
        batch: list = []
        with self._cv:
            if block and not self._queue and not self._stopped:
                self._cv.wait_for(
                    lambda: bool(self._queue) or self._stopped, timeout)
            deadline = time.monotonic() + wait_more
            while True:
                while self._queue and len(batch) < self.policy.max_batch:
                    batch.append(self._queue.popleft())
                if (not batch or self._stopped
                        or len(batch) >= self.policy.max_batch):
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cv.wait(left)
        return batch

    def drain_once(self, block: bool = True,
                   timeout: Optional[float] = None) -> int:
        """Serve one batch; returns how many requests were answered."""
        batch = self._collect(block, timeout)
        if not batch:
            return 0
        replies: dict = {}
        for req in batch:
            reply = replies.get(req.have_round)
            if reply is None:
                reply = build_reply(self.store, self.policy, req.have_round)
                replies[req.have_round] = reply
            req._resolve(reply)
        with self._cv:
            self._stats["served"] += len(batch)
            self._stats["batches"] += 1
            self._stats["groups"] += len(replies)
        return len(batch)

    def _serve_loop(self) -> None:
        while True:
            with self._cv:
                if self._stopped and not self._queue:
                    return
            self.drain_once(block=True, timeout=0.05)
