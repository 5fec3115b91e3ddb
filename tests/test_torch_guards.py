"""The port's runtime guard rails (repro_torch.analysis.guards): the
reference's guard cases (tests/test_analysis.py) translated, and the
engine routed through them.

On the CPU: `assert_compile_bounds` gives the reference's messages, the
campaign bound has one home (`ENGINE_COMPILE_BOUNDS`), `track_compiles`
counts what `record_compile` reports and nests, and
`no_implicit_transfers` sets the sync debug mode to "error" and restores
the previous mode, also when its block raises (torch's mode calls are
recorded: a CPU build of torch has no sync debug mode). Tests marked
``cuda`` run the engine on the card: a capture counted once and a replay
zero times, and a guarded replay raising on an injected ``.item()``.

No jax here, so the card cases run on a machine without it:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_guards.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.analysis import guards
from repro_torch.core import engine


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (graph capture, sync debug mode)")
    return torch.device("cuda")


@pytest.fixture
def sync_modes(monkeypatch):
    """torch's sync debug mode as a recorded value: the calls the guard
    makes, and the mode it leaves."""
    state = {"mode": 0, "calls": []}

    def set_mode(mode):
        state["calls"].append(mode)
        state["mode"] = mode

    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: state["mode"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    return state


def test_track_compiles_counts_recorded_compiles():
    with guards.track_compiles() as tracker:
        guards.record_compile("graph_captures")
        guards.record_compile("kernel_builds")
        guards.record_compile("kernel_builds")
    assert (tracker.graph_captures, tracker.kernel_builds,
            tracker.backend_compiles) == (1, 2, 3)
    guards.record_compile("graph_captures")      # no longer active
    assert tracker.backend_compiles == 3
    with guards.track_compiles() as tracker:
        pass                                     # steady state
    assert tracker.backend_compiles == 0
    with pytest.raises(ValueError, match="compile kind"):
        guards.record_compile("jit_round")


def test_track_compiles_nests_and_resets():
    with guards.track_compiles() as outer:
        guards.record_compile("graph_captures")
        with guards.track_compiles() as inner:
            guards.record_compile("graph_captures")
            guards.record_compile("kernel_builds")
        guards.record_compile("kernel_builds")
        assert (inner.graph_captures, inner.kernel_builds) == (1, 1)
        assert (outer.graph_captures, outer.kernel_builds) == (2, 2)
        outer.reset()
        assert outer.backend_compiles == 0
    assert not guards._TRACKERS


def test_assert_compile_bounds_enforces_engine_contract():
    guards.assert_compile_bounds({"graph": 1})
    guards.assert_compile_bounds({"graph": 0, "unbounded_extra": 99})
    with pytest.raises(guards.GuardViolation, match="graph=2 > 1"):
        guards.assert_compile_bounds({"graph": 2}, what="test")
    with pytest.raises(guards.GuardViolation, match="steady_state=1 > 0"):
        guards.assert_compile_bounds({"steady_state": 1},
                                     {"steady_state": 0})
    # the contract has exactly one home
    assert guards.ENGINE_COMPILE_BOUNDS == {"graph": 1}


def test_engine_compile_counts_name_the_bounded_counters():
    """`compile_counts` reports exactly the counters the bound names, so
    `assert_compile_bounds(compile_counts(sc))` checks every one."""
    from repro_torch.core.scenario import Scenario
    rs = np.random.RandomState(0)
    sc = Scenario(data=[rs.rand(6, 4, 4, 3).astype(np.float32)
                        for _ in range(4)], n_vehicles=4,
                  vehicles_per_round=2, batch_size=2, device="cpu")
    assert set(engine.compile_counts(sc)) == set(guards.ENGINE_COMPILE_BOUNDS)
    guards.assert_compile_bounds(engine.compile_counts(sc))


def test_no_implicit_transfers_restores_the_mode(sync_modes):
    sync_modes["mode"] = 1                       # "warn" before the block
    with guards.no_implicit_transfers():
        assert sync_modes["mode"] == "error"
    assert sync_modes["mode"] == 1
    with pytest.raises(RuntimeError, match="boom"):
        with guards.no_implicit_transfers():
            raise RuntimeError("boom")
    assert sync_modes["mode"] == 1
    assert sync_modes["calls"] == ["error", 1, "error", 1]


def test_engine_guards_through_no_implicit_transfers(sync_modes):
    """The engine's transfer guard is `no_implicit_transfers`: on around
    the rounds with transfer_guard, untouched without it."""
    assert not hasattr(engine, "_sync_guard")
    with engine._transfer_guard(True):
        assert sync_modes["mode"] == "error"
    with engine._transfer_guard(False):
        assert sync_modes["mode"] == 0
    assert sync_modes["calls"] == ["error", 0]


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

def _card_scenario(dev):
    from repro_torch.core.scenario import Scenario
    rs = np.random.RandomState(0)
    return Scenario(data=[rs.rand(24, 16, 16, 3).astype(np.float32)
                          for _ in range(6)], n_vehicles=6,
                    vehicles_per_round=3, batch_size=8, rounds=4,
                    device=dev)


@pytest.mark.cuda
def test_capture_counted_once_and_replays_zero_times(cuda):
    sc = _card_scenario(cuda)
    engine.reset_engine_caches()
    try:
        with guards.track_compiles() as first:
            state, _ = engine.run_campaign(sc, rounds=2, mode="graph")
        assert first.graph_captures == 1
        with guards.track_compiles() as warm:
            engine.run_campaign(sc, state, rounds=2, mode="graph",
                                transfer_guard=True)
        assert (warm.graph_captures, warm.kernel_builds) == (0, 0)
        assert engine.compile_counts(sc) == guards.ENGINE_COMPILE_BOUNDS
        guards.assert_compile_bounds(engine.compile_counts(sc))
    finally:
        engine.reset_engine_caches()


@pytest.mark.cuda
def test_guarded_replay_raises_on_an_injected_item(cuda, monkeypatch):
    sc = _card_scenario(cuda)
    engine.reset_engine_caches()
    try:
        state, _ = engine.run_campaign(sc, rounds=1, mode="graph")
        replay = engine._GraphRound.replay

        def replay_and_fetch(self, xs):
            losses = replay(self, xs)
            losses.sum().item()
            return losses

        monkeypatch.setattr(engine._GraphRound, "replay", replay_and_fetch)
        engine.run_campaign(sc, state, rounds=1, mode="graph")  # unguarded
        with pytest.raises(RuntimeError, match="synchroniz"):
            engine.run_campaign(sc, state, rounds=1, mode="graph",
                                transfer_guard=True)
        assert torch.cuda.get_sync_debug_mode() == 0
    finally:
        engine.reset_engine_caches()
