"""Training-curve statistics — counterpart of `repro.core.federation`
(`gradient_std` only; the reference's `FederatedTrainer` is a
back-compat shim over `run_round` and is not ported)."""
from __future__ import annotations

import numpy as np


def gradient_std(losses) -> float:
    """Paper Fig. 6 stability metric: std of the loss-curve gradient."""
    diffs = np.diff(np.asarray(losses, np.float64))
    return float(np.std(diffs))
