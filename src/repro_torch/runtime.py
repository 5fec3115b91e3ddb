"""Device resolution and the float32 parity mode.

No JAX counterpart: JAX picks its backend globally, the port takes an
explicit `device` at every entry point.

* `resolve_device(None)` is CUDA. A caller that wants the CPU (the tests,
  the cross-check in chip_smoke.py) passes ``device="cpu"``; asking for
  CUDA where there is none raises — there is no silent CPU path.
* `set_parity_mode()` makes float32 mean float32 on the card: cuDNN
  convolutions default to TF32 on Hopper
  (``torch.backends.cudnn.allow_tf32 = True``, about three decimal
  digits), and matmuls follow ``float32_matmul_precision``. The port
  turns both to full float32 so it can be held against the JAX reference;
  every `Scenario` sets it.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` (None means CUDA) as a torch.device; raises if CUDA is
    asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def set_parity_mode() -> None:
    """Full-float32 convolutions and matmuls (no TF32) — see module doc."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
