#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with one CUDA card,
nvcc and PyTorch built for CUDA. Imports nothing of JAX and nothing of
the JAX package `repro`. Phases, each of which must pass:

1. Prints the card (``nvidia-smi --query-gpu=name,power.limit``) and the
   torch/CUDA versions, then builds every kernel of
   src/repro_torch/kernels/csrc/ with nvcc (in parallel) into build/.
2. Kernel phase: each kernel against its plain PyTorch version on the
   card, at the main path's shapes —
   * wagg at m = 5, P = 11,506,624 (ResNet-18-CIFAR's flat row): plain,
     masked, padded to m = 8 with n = 5 (bitwise equal to the unpadded
     call), and cut to P - 3 columns (bitwise equal to the aligned call's
     first P - 3); atol 1e-5 against `ref.wagg_ref`;
   * dt_loss at (512, 128) and (500, 128): loss, lse_a, lse_b, pos at
     atol 2e-5 against `ref.dt_loss_fwd_ref`; gradients of the mean loss
     through the autograd.Function at atol 1e-5 against autograd of the
     plain `core.dt_loss.dt_loss_matrix`.
   Times each with CUDA events (kernel, plain version, and for wagg the
   library yardstick ``w @ x``, which the port never calls).
3. Cross-check: one small round on the card and the same round with
   ``device="cpu"``, compared with allclose (tolerances below).
4. Main path: 3 rounds of the paper's Table-1 setting (95 vehicles,
   Dirichlet 0.1, 5 per round, batch 512, ResNet-18-CIFAR at full width)
   through `Scenario` / `run_round`, with every kernel launch counter set
   to 0 just before and read just after.

The last three lines of standard output are the ``kernels`` JSON line,
the nvidia-smi line, and ``{"ok": true, "device": {...}}``. On any
failure, or without a CUDA card, or outside a checkout, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
F32_FLOP_PER_S = 67e12      # H100 SXM float32 outside the tensor cores

WAGG_P = 11_506_624         # ResNet-18-CIFAR params + BN stats
WAGG_TOL = 1e-5
DT_FWD_TOL = 2e-5
DT_GRAD_TOL = 1e-5
# Card vs CPU after one round. cuDNN and the CPU sum convolutions in
# different orders, and a ReLU input within that rounding of 0 can switch
# sides; one SGD step at lr 0.9 carries it into the tree. Held as in
# tests/test_torch_round.py: loss, max abs tree difference, and the norm
# of the difference relative to the norm of the round's update.
CROSS_LOSS_TOL = 1e-4
CROSS_MAX_ABS = 1e-2
CROSS_REL_UPDATE = 2e-2


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def kernel_phase(dev):
    import torch

    from repro_torch.core.dt_loss import dt_loss_matrix
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(0)
    rows = []

    # -- wagg --------------------------------------------------------------
    m, n_pad = 5, 8
    x = torch.randn((m, WAGG_P), generator=g, device=dev)
    w = torch.softmax(torch.randn(m, generator=g, device=dev), 0)
    ones = torch.ones(m, device=dev)
    mask = torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0], device=dev)
    errs = []
    out = ops.wagg_flat(x, w)
    errs.append(_max_err(out, ref.wagg_ref(x, w)))
    out_m = ops.wagg_flat(x, w, mask)
    errs.append(_max_err(out_m, ref.wagg_ref(x, w, mask)))
    xp = torch.cat([x, x[-1:].expand(n_pad - m, -1)]).contiguous()
    wp = torch.cat([w, torch.zeros(n_pad - m, device=dev)])
    mp = torch.cat([ones, torch.zeros(n_pad - m, device=dev)])
    out_p = ops.wagg_flat(xp, wp, mp)
    out_u = ops.wagg_flat(x, w, ones)
    torch.cuda.synchronize()
    if not (torch.equal(out_p, out_u) and torch.equal(out_u, out)):
        raise AssertionError("wagg: masked padded call is not bitwise equal "
                             "to the unpadded call")
    err = max(errs)
    if not err <= WAGG_TOL:
        raise AssertionError(f"wagg: max abs err {err} > {WAGG_TOL}")
    del xp
    # P % 4 == 1: rows are no longer 16-byte aligned, so every column
    # takes the kernel's column-by-column branch, with the same sums
    xr = x[:, :WAGG_P - 3].contiguous()
    out_r = ops.wagg_flat(xr, w)
    torch.cuda.synchronize()
    if not torch.equal(out_r, out[:WAGG_P - 3]):
        raise AssertionError("wagg: ragged call (P % 4 == 1) is not bitwise "
                             "equal to the aligned call")
    del xr
    ms = _time_ms(lambda: ops.wagg_flat(x, w, ones))
    plain_ms = _time_ms(lambda: ref.wagg_ref(x, w, ones))
    lib_ms = _time_ms(lambda: torch.matmul(w, x))
    nbytes = 4 * (m * WAGG_P + WAGG_P + 2 * m)
    flops = 2 * m * WAGG_P
    b_bytes, b_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    rows.append({"name": "wagg", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/wagg.cu",
                 "replaces": "src/repro/kernels/wagg.py:26",
                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": 1e3 * max(b_bytes, b_ops),
                 "bound_by": "bytes" if b_bytes >= b_ops else "operations",
                 "library_ms": lib_ms})
    print(f"[kernels] wagg m={m} P={WAGG_P}: max_abs_err={err:.3e} "
          f"padded==unpadded, ragged==aligned bitwise; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, w@x {lib_ms:.4f} ms", flush=True)
    del x

    # -- dt_loss -----------------------------------------------------------
    errs, timing = [], None
    for M in (512, 500):
        q = torch.nn.functional.normalize(
            torch.randn((M, 128), generator=g, device=dev), dim=-1)
        k = torch.nn.functional.normalize(
            torch.randn((M, 128), generator=g, device=dev), dim=-1)
        got = ops.dt_loss_fwd(q, k, 0.1, 1.0)
        want = ref.dt_loss_fwd_ref(q, k, 0.1, 1.0)
        fwd_err = max(_max_err(a, b) for a, b in zip(got, want))
        if not fwd_err <= DT_FWD_TOL:
            raise AssertionError(f"dt_loss fwd M={M}: {fwd_err} > "
                                 f"{DT_FWD_TOL}")
        q1, k1 = q.clone().requires_grad_(), k.clone().requires_grad_()
        q2, k2 = q.clone().requires_grad_(), k.clone().requires_grad_()
        gq1, gk1 = torch.autograd.grad(ops.dt_loss(q1, k1, 0.1, 1.0),
                                       (q1, k1))
        gq2, gk2 = torch.autograd.grad(dt_loss_matrix(q2, k2, 0.1, 1.0),
                                       (q2, k2))
        grad_err = max(_max_err(gq1, gq2), _max_err(gk1, gk2))
        if not grad_err <= DT_GRAD_TOL:
            raise AssertionError(f"dt_loss grad M={M}: {grad_err} > "
                                 f"{DT_GRAD_TOL}")
        errs.append(max(fwd_err, grad_err))
        print(f"[kernels] dt_loss M={M} D=128: fwd err {fwd_err:.3e}, "
              f"grad err {grad_err:.3e}", flush=True)
        if M == 512:
            timing = (_time_ms(lambda: ops.dt_loss_fwd(q, k, 0.1, 1.0),
                               iters=200),
                      _time_ms(lambda: ref.dt_loss_fwd_ref(q, k, 0.1, 1.0),
                               iters=200))
    M, D = 512, 128
    b_bytes = 4 * (2 * M * D + 4 * M) / HBM_BYTES_PER_S
    b_ops = 2 * M * M * D / F32_FLOP_PER_S
    rows.append({"name": "dt_loss", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/dt_loss.cu",
                 "replaces": "src/repro/kernels/dt_loss.py:33",
                 "max_abs_err": max(errs), "ms": timing[0],
                 "plain_ms": timing[1],
                 "bound_ms": 1e3 * max(b_bytes, b_ops),
                 "bound_by": "bytes" if b_bytes >= b_ops else "operations",
                 "library_ms": None})
    print(f"[kernels] dt_loss (512,128): kernel {timing[0]:.4f} ms, plain "
          f"{timing[1]:.4f} ms", flush=True)
    return rows


def cross_check(dev):
    """One small round on the card and on the CPU, same plan."""
    import numpy as np
    import torch

    from repro_torch.convert import ravel
    from repro_torch.core.scenario import Scenario, run_round

    rs = np.random.RandomState(0)
    data = [rs.rand(24, 16, 16, 3).astype(np.float32) for _ in range(4)]
    kw = dict(n_vehicles=4, vehicles_per_round=2, batch_size=8, data=data,
              rounds=4)
    out = []
    for d in (dev, "cpu"):
        sc = Scenario(device=d, **kw)
        state = sc.init_state()
        start = ravel(state.global_tree).cpu()
        st, rec = run_round(state, sc)
        out.append((ravel(st.global_tree).cpu(), rec))
    (t_gpu, r_gpu), (t_cpu, r_cpu) = out
    max_abs = float((t_gpu - t_cpu).abs().max())
    rel = float((t_gpu - t_cpu).norm() / (t_cpu - start).norm())
    dloss = abs(r_gpu["loss"] - r_cpu["loss"])
    print(f"[cross] card vs cpu: loss {r_gpu['loss']:.7f} vs "
          f"{r_cpu['loss']:.7f}, tree max abs diff {max_abs:.3e}, relative "
          f"to the update {rel:.3e}", flush=True)
    if r_gpu["velocities"] != r_cpu["velocities"]:
        raise AssertionError("cross-check: velocities differ")
    if not bool(torch.isfinite(t_gpu).all()):
        raise AssertionError("cross-check: card tree not finite")
    if not (dloss <= CROSS_LOSS_TOL and max_abs <= CROSS_MAX_ABS
            and rel <= CROSS_REL_UPDATE):
        raise AssertionError(f"cross-check: loss diff {dloss}, tree max "
                             f"abs {max_abs}, relative {rel}")


def main_path(dev):
    """3 Table-1 rounds; returns launches per kernel."""
    import math

    import torch

    from repro_torch.convert import ravel
    from repro_torch.core.aggregation import flsimco_weights
    from repro_torch.core.scenario import Scenario, run_round
    from repro_torch.kernels import dt_loss as dt_kernel
    from repro_torch.kernels import wagg as wagg_kernel

    t0 = time.time()
    sc = Scenario(topology="single", client="dtssl", aggregator="flsimco",
                  partitioner="dirichlet", alpha=0.1, n_per_class=5000,
                  min_per_client=520, n_vehicles=95, vehicles_per_round=5,
                  batch_size=512, local_iters=1, device=dev)
    state = sc.init_state()
    print(f"[main] data {len(sc.dataset[0])} images over "
          f"{len(sc.data)} vehicles, set-up {time.time() - t0:.2f} s",
          flush=True)
    before = ravel(state.global_tree).clone()
    rounds = 3
    torch.cuda.synchronize()
    wagg_kernel.LAUNCHES = 0
    dt_kernel.LAUNCHES = 0
    for _ in range(rounds):
        t = time.time()
        state, rec = run_round(state, sc)
        torch.cuda.synchronize()
        dt = time.time() - t
        w = flsimco_weights(sc.mobility.blur_level(rec["velocities"]))
        print(f"[main] round {rec['round']}: {dt:.3f} s, loss "
              f"{rec['loss']:.6f}, lr {rec['lr']:.6f}, weights "
              f"{[round(float(x), 4) for x in w]}", flush=True)
        if not math.isfinite(rec["loss"]):
            raise AssertionError(f"round {rec['round']}: loss not finite")
        if abs(float(w.sum()) - 1.0) > 1e-6:
            raise AssertionError(f"Eq.-11 weights sum to {float(w.sum())}")
    launches = {"wagg": wagg_kernel.LAUNCHES, "dt_loss": dt_kernel.LAUNCHES}
    after = ravel(state.global_tree)
    if after.shape != before.shape or not bool(torch.isfinite(after).all()):
        raise AssertionError("global tree has the wrong shape or is not "
                             "finite")
    if torch.equal(after, before):
        raise AssertionError("global tree did not change")
    want = {"wagg": rounds, "dt_loss": rounds * sc.cfg.vehicles_per_round
            * sc.cfg.local_iters}
    print(f"[main] launches {launches} (expected {want}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    return launches


def run() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.kernels import build
    from repro_torch.runtime import set_parity_mode

    smi = _smi()
    print(f"[card] {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    t = time.time()
    libs = build.build_all()
    print(f"[build] {len(libs)} kernels in {time.time() - t:.2f} s: "
          f"{[os.path.basename(p) for p in libs]}", flush=True)
    set_parity_mode()
    dev = torch.device("cuda", 0)
    rows = kernel_phase(dev)
    cross_check(dev)
    launches = main_path(dev)
    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = run()
    except Exception:   # any failed phase: report and exit non-zero
        traceback.print_exc()
        code = 1
    sys.exit(code)
