"""ResNet-18 (CIFAR variant) + 128-D projection head — the FLSimCo backbone.

Counterpart of `repro.models.resnet` (`init_resnet`, `resnet_apply`).
CIFAR stem (3x3 conv stride 1, no max-pool), stages [2,2,2,2] at widths
[64,128,256,512], BatchNorm with running stats, global average pool, and
a 2-layer MLP projector to 128-D (L2-normalized output).

Functional, like the reference: the model is a ``{"params", "state"}``
dict of tensors in the reference's layouts (conv weights HWIO, images
NHWC at the public function), so a converted reference tree runs as is
(convert.py) and ravels to the reference's flat row. Inside, activations
run NCHW, the layout `torch.nn.functional.conv2d` takes.

Two places where PyTorch's defaults differ from the reference:

* Padding. XLA "SAME" on a 3x3 stride-2 convolution over an even input
  pads (0, 1), while ``conv2d(padding=1)`` pads (1, 1); `_conv` computes
  the SAME split itself. The 1x1 stride-2 projection pads 0.
* BatchNorm. The reference normalises with the BIASED batch variance and
  updates the running stats with it too (``new = 0.9*old + 0.1*batch``,
  eps 1e-5); ``nn.BatchNorm2d`` would store the unbiased variance. `_bn`
  is written out here.

`resnet_apply` does nothing in place, so it runs under `torch.func.vmap`
(the batched cohort step, core/clients.py) with the tree unbatched: the
convolutions then take the chunk's images as one batch against one
weight, while BN's statistics stay per client (they reduce over each
client's own N, H, W) and the running-stat update stays detached.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.convert import tree_map
from repro_torch.runtime import resolve_device

STAGES = (2, 2, 2, 2)
WIDTHS = (64, 128, 256, 512)


def _normal(gen, shape, std) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32) * std


def _conv_init(gen, kh, kw, cin, cout) -> torch.Tensor:
    """He-normal, std = sqrt(2/fan_in), HWIO."""
    return _normal(gen, (kh, kw, cin, cout), math.sqrt(2.0 / (kh * kw * cin)))


def _init_bn(c):
    return ({"scale": torch.ones(c), "bias": torch.zeros(c)},
            {"mean": torch.zeros(c), "var": torch.ones(c)})


def init_resnet(cfg, generator: torch.Generator, device=None) -> dict:
    """Random round-0 model, drawn in the reference's leaf order from a
    CPU `generator` (the same numbers on every device), then moved to
    `device`. Returns ``{"params": ..., "state": ...}``."""
    device = resolve_device(device)
    gen = generator
    params: dict = {}
    state: dict = {}
    params["stem"] = _conv_init(gen, 3, 3, 3, WIDTHS[0])
    params["stem_bn"], state["stem_bn"] = _init_bn(WIDTHS[0])
    cin = WIDTHS[0]
    for si, (n_blocks, w) in enumerate(zip(STAGES, WIDTHS)):
        for bi in range(n_blocks):
            name = f"s{si}b{bi}"
            stride = 2 if (bi == 0 and si > 0) else 1
            blk: dict = {"conv1": _conv_init(gen, 3, 3, cin, w),
                         "conv2": _conv_init(gen, 3, 3, w, w)}
            st: dict = {}
            blk["bn1"], st["bn1"] = _init_bn(w)
            blk["bn2"], st["bn2"] = _init_bn(w)
            if stride != 1 or cin != w:
                blk["proj"] = _conv_init(gen, 1, 1, cin, w)
                blk["proj_bn"], st["proj_bn"] = _init_bn(w)
            params[name] = blk
            state[name] = st
            cin = w
    # projector: 512 -> 512 -> 128
    params["proj1"] = _normal(gen, (WIDTHS[-1], WIDTHS[-1]),
                              1 / math.sqrt(WIDTHS[-1]))
    params["proj1_b"] = torch.zeros(WIDTHS[-1])
    params["proj2"] = _normal(gen, (WIDTHS[-1], cfg.d_ff),
                              1 / math.sqrt(WIDTHS[-1]))
    return tree_map(lambda t: t.to(device),
                    {"params": params, "state": state})


def _same_pad(size: int, k: int, stride: int):
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NCHW x HWIO -> NCHW with XLA "SAME" padding."""
    kh, kw = w.shape[0], w.shape[1]
    top, bottom = _same_pad(x.shape[2], kh, stride)
    left, right = _same_pad(x.shape[3], kw, stride)
    wt = w.permute(3, 2, 0, 1)                                # OIHW
    if top == bottom and left == right:
        return F.conv2d(x, wt, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), wt, stride=stride)


def _bn(p, s, x: torch.Tensor, train: bool, momentum: float = 0.9):
    """BatchNorm over N,H,W of an NCHW tensor. Returns (y, new_state)."""
    if train:
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        new_s = {"mean": momentum * s["mean"] + (1 - momentum) * mean.detach(),
                 "var": momentum * s["var"] + (1 - momentum) * var.detach()}
    else:
        mean, var = s["mean"], s["var"]
        new_s = s
    inv = torch.rsqrt(var + 1e-5)
    y = (x - mean[:, None, None]) * inv[:, None, None]
    return y * p["scale"][:, None, None] + p["bias"][:, None, None], new_s


def resnet_apply(tree: dict, x: torch.Tensor, train: bool = True):
    """x: (B, H, W, 3) NHWC -> (z128 L2-normalized, h512 pre-projector,
    {"params": params, "state": new_state})."""
    p, s = tree["params"], tree["state"]
    ns: dict = {}
    h = _conv(x.permute(0, 3, 1, 2), p["stem"])
    h, ns["stem_bn"] = _bn(p["stem_bn"], s["stem_bn"], h, train)
    h = F.relu(h)
    for si, n_blocks in enumerate(STAGES):
        for bi in range(n_blocks):
            name = f"s{si}b{bi}"
            blk, bst = p[name], s[name]
            stride = 2 if (bi == 0 and si > 0) else 1
            nbs: dict = {}
            y = _conv(h, blk["conv1"], stride)
            y, nbs["bn1"] = _bn(blk["bn1"], bst["bn1"], y, train)
            y = F.relu(y)
            y = _conv(y, blk["conv2"])
            y, nbs["bn2"] = _bn(blk["bn2"], bst["bn2"], y, train)
            if "proj" in blk:
                sc = _conv(h, blk["proj"], stride)
                sc, nbs["proj_bn"] = _bn(blk["proj_bn"], bst["proj_bn"], sc,
                                         train)
            else:
                sc = h
            h = F.relu(y + sc)
            ns[name] = nbs
    h = h.mean(dim=(2, 3))                                    # (B, 512)
    z = F.relu(h @ p["proj1"] + p["proj1_b"])
    z = z @ p["proj2"]                                        # (B, 128)
    z = z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True),
                        min=1e-8)
    return z, h, {"params": p, "state": ns}
