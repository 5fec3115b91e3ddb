"""What the drivers share: the ``--device`` flag and the checks each
driver holds on its results, bitwise on the CPU and within the card's
bound on CUDA.

Runs on the card are not bitwise repeatable (cuDNN and cuBLAS pick their
algorithms per call), so a driver that compares two runs holds the model
trees on the card within `CARD_MAX_ABS` and the losses within
`CARD_LOSS_TOL`, chip_smoke.py's CROSS_MAX_ABS and CROSS_LOSS_TOL.
Everything on the host (the schedule, host_rng, gen_state, positions and
sync statistics) is bitwise on both.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.checkpoint.store import _leaves
from repro_torch.runtime import resolve_device

CARD_MAX_ABS = 1e-2
CARD_LOSS_TOL = 1e-4


def parser(doc: str) -> argparse.ArgumentParser:
    """A driver's parser (its docstring's first line as the description)
    with ``--device``: the card by default, ``cpu`` to run the plain
    PyTorch path."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    return ap


def device_of(a) -> torch.device:
    """The parsed ``--device``, resolved (raises without a card unless
    ``cpu`` was asked for)."""
    return resolve_device(a.device)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def bitwise(a, b) -> bool:
    """Whether two FLStates are equal leaf for leaf, bit for bit."""
    la, lb = _leaves(a.to_tree()), _leaves(b.to_tree())
    return len(la) == len(lb) and all(
        np.array_equal(_host(x), _host(y)) for x, y in zip(la, lb))


def state_gap(a, b) -> tuple:
    """(max abs difference of the two FLStates' leaves on the card, the
    indices of their other leaves that differ): the host leaves and CPU
    tensors, held bitwise. On the CPU the first is 0 and every leaf is
    held bitwise."""
    worst, unequal = 0.0, []
    la, lb = _leaves(a.to_tree()), _leaves(b.to_tree())
    if len(la) != len(lb):
        return float("inf"), ["structure"]
    for i, (x, y) in enumerate(zip(la, lb)):
        if isinstance(x, torch.Tensor) and x.is_cuda:
            # analysis: sanctioned-sync -- a driver's check, once a run
            worst = max(worst, float((x - y).abs().max()))
        elif not np.array_equal(_host(x), _host(y)):
            unequal.append(i)
    return worst, unequal


def hold_states(what: str, a, b, step: float = 0.0) -> float:
    """Raise unless two FLStates agree: host leaves bitwise, card leaves
    within CARD_MAX_ABS (+ `step`, one int8 code step where a codec may
    flip a code). Returns the card leaves' max abs difference."""
    gap, unequal = state_gap(a, b)
    if unequal or gap > CARD_MAX_ABS + step:
        raise AssertionError(f"{what}: leaves {unequal} differ, card "
                             f"leaves max abs {gap:.3e} (bound "
                             f"{CARD_MAX_ABS + step:.3e})")
    return gap


def sans_loss(history) -> list:
    return [{k: v for k, v in r.items() if k != "loss"} for r in history]


def hold_losses(what: str, a, b, device) -> float:
    """Raise unless two histories' losses agree: equal on the CPU, within
    CARD_LOSS_TOL on the card. Returns the max abs difference."""
    la = np.array([r["loss"] for r in a])
    lb = np.array([r["loss"] for r in b])
    gap = float(np.abs(la - lb).max()) if len(la) else 0.0
    tol = CARD_LOSS_TOL if torch.device(device).type == "cuda" else 0.0
    if la.shape != lb.shape or gap > tol:
        raise AssertionError(f"{what}: losses {la.tolist()} vs "
                             f"{lb.tolist()} (bound {tol})")
    return gap
