"""Runtime guard rails shared by the engine, chip_smoke.py and the tests.

Counterpart of `repro.analysis.guards` (`ENGINE_COMPILE_BOUNDS`,
`GuardViolation`, `CompileTracker`, `track_compiles`,
`no_implicit_transfers`, `assert_compile_bounds`). Two rails:

``no_implicit_transfers()``
    ``torch.cuda.set_sync_debug_mode("error")`` as a context manager,
    the previous mode restored on the way out. Inside it, every call
    that makes the host wait on the card through torch's sync check
    raises: ``.item()`` (so ``float(t)`` and ``int(t)`` too), a
    ``.cpu()`` of a CUDA tensor and any other blocking device-to-host
    copy. chip_smoke.py ``[analysis]`` holds ``.item()`` and ``.cpu()``
    raising on the card, and prints that an explicit
    ``torch.cuda.synchronize()`` does not raise (NVIDIA H100, torch
    2.11). Torch calls the mode a prototype that does not yet detect
    every synchronizing operation. What it also cannot catch: the
    reference's guard also refuses an implicit numpy upload into a
    jitted body; torch has no such upload (an op that mixes a CPU and a
    CUDA tensor raises by itself), and a non-blocking host-to-device
    copy does not make the host wait, so it passes. Warm and capture
    outside the guard (the first round of a campaign runs eagerly and
    loads every kernel library) and wrap only the steady-state replays:
    ``core.engine.run_campaign(transfer_guard=True)`` does this. CUDA
    only: the sync debug mode watches the card, so the engine refuses
    the flag for a CPU scenario.

``track_compiles()`` / ``assert_compile_bounds()``
    The port compiles nothing through XLA. Its counterparts of a backend
    compile are a CUDA graph capture (``core/engine.py`` `_GraphRound`)
    and a kernel library built by nvcc or loaded with ``ctypes.CDLL``
    (``kernels/build.py``). Both call `record_compile`, which counts into
    every active tracker: ``graph_captures``, ``kernel_builds``, and
    ``backend_compiles``, their sum. The campaign contract lives here
    (`ENGINE_COMPILE_BOUNDS`) and nowhere else; chip_smoke.py and the
    engine tests import it instead of hand-pinning integers.

One process-wide list of active trackers, under one lock, as in the
reference: trackers nest and the dispatch is re-entrant.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterator, Mapping, Optional

__all__ = [
    "ENGINE_COMPILE_BOUNDS",
    "CompileTracker",
    "GuardViolation",
    "assert_compile_bounds",
    "no_implicit_transfers",
    "record_compile",
    "track_compiles",
]

# The one home of the campaign-compilation contract: a campaign captures
# its round body at most once per campaign key (`engine.compile_counts`).
# The reference's {"jit_round": 1, "scan": 2} maps onto it so: its "jit"
# mode is the port's eager mode, which captures nothing; its "scan" is the
# port's graph mode. A graph holds ONE round and a chunk is a loop of
# replays, so a shorter trailing chunk replays the same graph: the
# reference's second scan trace has no counterpart.
ENGINE_COMPILE_BOUNDS: Dict[str, int] = {"graph": 1}

# what `record_compile` counts, as `CompileTracker` names the counters
COMPILE_KINDS = ("graph_captures", "kernel_builds")


class GuardViolation(AssertionError):
    """A runtime guard-rail contract was violated."""


@dataclass
class CompileTracker:
    """Counts graph captures and kernel library builds or loads observed
    while active. Use via :func:`track_compiles`."""

    graph_captures: int = 0
    kernel_builds: int = 0
    _active: bool = field(default=False, repr=False)

    @property
    def backend_compiles(self) -> int:
        return self.graph_captures + self.kernel_builds

    def reset(self) -> None:
        self.graph_captures = 0
        self.kernel_builds = 0

    def _record(self, kind: str) -> None:
        if self._active:
            setattr(self, kind, getattr(self, kind) + 1)


_LOCK = threading.Lock()
_TRACKERS: list = []


def record_compile(kind: str) -> None:
    """One capture (``"graph_captures"``) or one kernel library built or
    loaded (``"kernel_builds"``), counted into every active tracker."""
    if kind not in COMPILE_KINDS:
        raise ValueError(f"compile kind {kind!r} not in {COMPILE_KINDS}")
    with _LOCK:
        active = list(_TRACKERS)
    for tracker in active:
        tracker._record(kind)


@contextlib.contextmanager
def track_compiles() -> Iterator[CompileTracker]:
    """Count graph captures and kernel builds inside the ``with`` block.

    >>> with track_compiles() as tracker:
    ...     run_campaign(sc, state, 2, mode="graph")   # captured already?
    >>> assert tracker.graph_captures == 0
    """
    tracker = CompileTracker()
    tracker._active = True
    with _LOCK:
        _TRACKERS.append(tracker)
    try:
        yield tracker
    finally:
        tracker._active = False
        with _LOCK:
            _TRACKERS.remove(tracker)


@contextlib.contextmanager
def no_implicit_transfers() -> Iterator[None]:
    """Raise on any host-device synchronisation torch makes in the block
    (`torch.cuda.set_sync_debug_mode("error")`); the previous mode comes
    back on exit, also when the block raises. Capture outside the guard."""
    import torch

    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def assert_compile_bounds(
    counts: Mapping[str, int],
    bounds: Optional[Mapping[str, int]] = None,
    *,
    what: str = "campaign",
) -> None:
    """Assert every counter in ``counts`` is within ``bounds``.

    ``bounds`` defaults to :data:`ENGINE_COMPILE_BOUNDS`. Counters in
    ``counts`` with no declared bound are ignored, so callers can pass
    ``core.engine.compile_counts(scenario)`` verbatim. Raises
    :class:`GuardViolation` naming every exceeded counter.
    """
    if bounds is None:
        bounds = ENGINE_COMPILE_BOUNDS
    exceeded = {
        name: (counts[name], limit)
        for name, limit in bounds.items()
        if counts.get(name, 0) > limit
    }
    if exceeded:
        detail = ", ".join(
            f"{name}={got} > {limit}" for name, (got, limit) in sorted(exceeded.items())
        )
        raise GuardViolation(
            f"{what} compile bounds exceeded: {detail} "
            f"(observed counts: {dict(counts)!r})"
        )
