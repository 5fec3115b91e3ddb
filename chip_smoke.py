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
5. Comms path: 3 more Table-1 rounds from round 0 with
   ``codec="delta_int8"`` through `Scenario` / `run`, each published into
   a ``ModelStore(codec="delta_int8")`` bootstrapped with round 0; the
   counters, zeroed just before, must read q8_encode 6 and q8_decode 6
   (3 cohort roundtrips, 3 publishes), wagg 3 and dt_loss 15.
6. Serve path: a fleet of 95 vehicles fetches from an
   ``RSUServer(start=False)`` over that store, driven by `drain_once`,
   with held rounds that give every reply kind (current, delta, full,
   shed); every applied reply must be bitwise the served tree, no request
   lost, and q8_decode launched once per delta hop applied (counters
   zeroed just before). Then a short threaded pass through
   `repro_torch.launch.serve.serve_campaign` (served/s, fetch p50/p99),
   and one more round with ``codec="delta"`` and with
   ``codec="identity"`` from the same state, bitwise equal on the card.

The q8 kernels are held against their plain versions in phase 2, at
(5, Ppad) and (1, Ppad), Ppad = 11,506,688: codes, scales, residuals and
the decode bitwise equal; a ragged P (through `ops`) bitwise equal to the
aligned call's columns; an all-zero block decodes to zeros. The library
yardstick of the decode is ``torch.mul(codes.view(N, -1, 256),
scales[..., None])``; the encode has none.

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
BQ = 256                    # q8 block: parameters sharing one scale
Q8_PPAD = -(-WAGG_P // BQ) * BQ
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


def _bound(nbytes: float, flops: float):
    b_bytes, b_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(b_bytes, b_ops), ("bytes" if b_bytes >= b_ops
                                       else "operations")


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
    bound_ms, bound_by = _bound(4 * (m * WAGG_P + WAGG_P + 2 * m),
                                2 * m * WAGG_P)
    rows.append({"name": "wagg", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/wagg.cu",
                 "replaces": "src/repro/kernels/wagg.py:26",
                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by,
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
    bound_ms, bound_by = _bound(4 * (2 * M * D + 4 * M), 2 * M * M * D)
    rows.append({"name": "dt_loss", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/dt_loss.cu",
                 "replaces": "src/repro/kernels/dt_loss.py:33",
                 "max_abs_err": max(errs), "ms": timing[0],
                 "plain_ms": timing[1], "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": None})
    print(f"[kernels] dt_loss (512,128): kernel {timing[0]:.4f} ms, plain "
          f"{timing[1]:.4f} ms", flush=True)
    return rows


def q8_kernels(dev):
    """q8_encode / q8_decode against the plain versions at (5, Ppad) (the
    cohort roundtrip) and (1, Ppad) (a snapshot publish or fetch)."""
    import torch

    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(1)
    times = {}
    for n in (5, 1):
        x = torch.randn((n, Q8_PPAD), generator=g, device=dev) * 1e-2
        e = torch.randn((n, Q8_PPAD), generator=g, device=dev) * 1e-4
        x[:, WAGG_P:] = 0.0      # the codec's zero padding past P
        e[:, WAGG_P:] = 0.0
        x[:, :BQ] = 0.0          # one all-zero block
        e[:, :BQ] = 0.0
        codes, scales, new_ef = ops.q8_encode_flat(x, e)
        out = ops.q8_decode_flat(codes, scales)
        c_r, s_r, e_r = ref.q8_encode_ref(x, e)
        out_r = ref.q8_decode_ref(codes, scales)
        # ragged P (not a multiple of 256): ops pads it with zeros
        c_g, s_g, e_g = ops.q8_encode_flat(x[:, :WAGG_P], e[:, :WAGG_P])
        out_g = ops.q8_decode_flat(c_g, s_g)
        torch.cuda.synchronize()
        if not (torch.equal(codes, c_r) and torch.equal(scales, s_r)
                and torch.equal(new_ef, e_r)):
            raise AssertionError(f"q8_encode ({n}, Ppad): not bitwise equal "
                                 f"to the plain version")
        if not torch.equal(out, out_r):
            raise AssertionError(f"q8_decode ({n}, Ppad): not bitwise equal "
                                 f"to the plain version")
        if not (torch.equal(c_g, codes[:, :WAGG_P])
                and torch.equal(s_g, scales)
                and torch.equal(e_g, new_ef[:, :WAGG_P])
                and torch.equal(out_g, out[:, :WAGG_P])):
            raise AssertionError(f"q8 ({n}, {WAGG_P}): ragged call is not "
                                 f"bitwise equal to the aligned call")
        if scales[:, 0].any() or codes[:, :BQ].any() or out[:, :BQ].any():
            raise AssertionError("q8: the all-zero block does not decode "
                                 "to zeros")
        del c_r, s_r, e_r, out_r, c_g, s_g, e_g, out_g
        times[n] = (
            _time_ms(lambda: ops.q8_encode_flat(x, e)),
            _time_ms(lambda: ref.q8_encode_ref(x, e)),
            _time_ms(lambda: ops.q8_decode_flat(codes, scales)),
            _time_ms(lambda: ref.q8_decode_ref(codes, scales)),
            _time_ms(lambda: torch.mul(codes.view(n, -1, BQ),
                                       scales[..., None])))
        print(f"[kernels] q8 ({n}, {Q8_PPAD}): codes, scales, new_ef and "
              f"decode bitwise equal to the plain versions, ragged "
              f"P={WAGG_P} == aligned, zero block exact; encode "
              f"{times[n][0]:.4f} ms (plain {times[n][1]:.4f}), decode "
              f"{times[n][2]:.4f} ms (plain {times[n][3]:.4f}, torch.mul "
              f"{times[n][4]:.4f})", flush=True)
        del x, e, codes, scales, new_ef, out
    n, elems = 5, 5 * Q8_PPAD
    blocks = elems // BQ
    enc_bound = _bound(elems * (4 + 4 + 1 + 4) + blocks * 4,
                       elems * 5 + blocks * 2)
    dec_bound = _bound(elems * (1 + 4) + blocks * 4, elems)
    common = {"route": "cuda", "source": "src/repro_torch/kernels/csrc/"
              "qdelta.cu", "max_abs_err": 0.0}
    enc_ms, enc_plain, dec_ms, dec_plain, dec_lib = times[n]
    return [dict(common, name="q8_encode",
                 replaces="src/repro/kernels/qdelta.py:32", ms=enc_ms,
                 plain_ms=enc_plain, bound_ms=enc_bound[0],
                 bound_by=enc_bound[1], library_ms=None),
            dict(common, name="q8_decode",
                 replaces="src/repro/kernels/qdelta.py:46", ms=dec_ms,
                 plain_ms=dec_plain, bound_ms=dec_bound[0],
                 bound_by=dec_bound[1], library_ms=dec_lib)]


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


def _zero_counts() -> None:
    from repro_torch.kernels import dt_loss, qdelta, wagg
    wagg.LAUNCHES = dt_loss.LAUNCHES = 0
    qdelta.ENCODE_LAUNCHES = qdelta.DECODE_LAUNCHES = 0


def _counts() -> dict:
    from repro_torch.kernels import dt_loss, qdelta, wagg
    return {"wagg": wagg.LAUNCHES, "dt_loss": dt_loss.LAUNCHES,
            "q8_encode": qdelta.ENCODE_LAUNCHES,
            "q8_decode": qdelta.DECODE_LAUNCHES}


def main_path(dev):
    """3 Table-1 rounds; returns (launches per kernel, the scenario, the
    final state)."""
    import math

    import torch

    from repro_torch.convert import ravel
    from repro_torch.core.aggregation import flsimco_weights
    from repro_torch.core.scenario import Scenario, run_round
    from repro_torch.trace_round import TABLE1

    t0 = time.time()
    sc = Scenario(device=dev, **TABLE1)
    state = sc.init_state()
    print(f"[main] data {len(sc.dataset[0])} images over "
          f"{len(sc.data)} vehicles, set-up {time.time() - t0:.2f} s",
          flush=True)
    before = ravel(state.global_tree).clone()
    rounds = 3
    torch.cuda.synchronize()
    _zero_counts()
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
    launches = _counts()
    after = ravel(state.global_tree)
    if after.shape != before.shape or not bool(torch.isfinite(after).all()):
        raise AssertionError("global tree has the wrong shape or is not "
                             "finite")
    if torch.equal(after, before):
        raise AssertionError("global tree did not change")
    want = {"wagg": rounds, "dt_loss": rounds * sc.cfg.vehicles_per_round
            * sc.cfg.local_iters, "q8_encode": 0, "q8_decode": 0}
    print(f"[main] launches {launches} (expected {want}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    return launches, sc, state


def comms_path(dev, main_sc, main_state):
    """3 Table-1 rounds with codec="delta_int8" through `run`, published
    into a delta_int8 store. Returns (launches, scenario, state, store)."""
    import math

    import torch

    from repro_torch.comms.codecs import flat_width
    from repro_torch.convert import ravel
    from repro_torch.core.scenario import Scenario, run
    from repro_torch.serve import ModelStore
    from repro_torch.trace_round import TABLE1

    sc = Scenario(device=dev, codec="delta_int8", data=main_sc.data,
                  **TABLE1)
    state = sc.init_state()
    store = ModelStore(codec="delta_int8")
    store.publish(state.round, state.global_tree)
    rounds = 3
    torch.cuda.synchronize()
    _zero_counts()
    for _ in range(rounds):
        t = time.time()
        state, (rec,) = run(sc, state, rounds=1, publish=store.publish)
        torch.cuda.synchronize()
        print(f"[comms] round {rec['round']} (delta_int8, published): "
              f"{time.time() - t:.3f} s, loss {rec['loss']:.6f}", flush=True)
        if not math.isfinite(rec["loss"]):
            raise AssertionError(f"comms round {rec['round']}: loss not "
                                 f"finite")
    launches = _counts()
    per = sc.cfg.vehicles_per_round * sc.cfg.local_iters
    want = {"wagg": rounds, "dt_loss": rounds * per, "q8_encode": 2 * rounds,
            "q8_decode": 2 * rounds}
    print(f"[comms] launches {launches} (expected {want})", flush=True)
    if launches != want:
        raise AssertionError(f"comms launches {launches} != {want}")
    ef = state.comms["ef"]
    tree = ravel(state.global_tree)
    if tuple(ef.shape) != (sc.cfg.vehicles_per_round,
                           flat_width(state.global_tree)) \
            or not bool(torch.isfinite(ef).all()) \
            or not bool(torch.isfinite(tree).all()):
        raise AssertionError("comms: EF or tree of the wrong shape or not "
                             "finite")
    if store.rounds() != list(range(rounds + 1)):
        raise AssertionError(f"comms: store holds rounds {store.rounds()}")
    ident = ravel(main_state.global_tree)
    start = ravel(sc.init_state().global_tree)
    print(f"[comms] after {rounds} rounds, delta_int8 vs identity tree: max "
          f"abs diff {float((tree - ident).abs().max()):.3e}, "
          f"{float((tree - ident).norm() / (ident - start).norm()):.3e} of "
          f"the identity run's update; EF max abs "
          f"{float(ef.abs().max()):.3e}; snapshot payload "
          f"{store.get(rounds).delta_nbytes} bytes", flush=True)
    return launches, sc, state, store


def serve_path(store):
    """95 vehicles against an RSUServer driven by drain_once, every reply
    kind; returns the counts of reply kinds."""
    import torch

    from repro_torch.convert import ravel
    from repro_torch.serve import RSUServer, ServePolicy, apply_reply

    latest = store.latest_round
    server = RSUServer(store, ServePolicy(max_lag=1, queue_limit=64),
                       start=False)
    # held rounds cycle over every published round: the latest is
    # "current", one behind is a 1-hop "delta", older ones are "full",
    # and whatever exceeds the 64-deep queue is "shed"
    held = [i % (latest + 1) for i in range(95)]
    torch.cuda.synchronize()
    _zero_counts()
    t = time.time()
    pends = [server.submit(h) for h in held]
    while server.drain_once(block=False):
        pass
    kinds, hops, bad = {}, 0, 0
    for h, pend in zip(held, pends):
        rep = pend.result(timeout=0)
        kind = rep.kind if rep.status == "ok" else rep.status
        kinds[kind] = kinds.get(kind, 0) + 1
        if rep.status != "ok":
            continue
        tree = apply_reply(rep, store.get(h).served_tree, codec=store.codec)
        hops += len(rep.payloads) if rep.kind == "delta" else 0
        if not torch.equal(ravel(tree),
                           ravel(store.get(rep.round).served_tree)):
            bad += 1
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = _counts()
    st = server.stats()
    lost = st["submitted"] - st["served"] - st["shed"]
    print(f"[serve] 95 vehicles: replies {kinds}, {hops} delta hops "
          f"applied, {bad} trees not bitwise the served tree, {lost} lost; "
          f"launches {launches}; {wall:.3f} s", flush=True)
    if set(kinds) != {"current", "delta", "full", "shed"}:
        raise AssertionError(f"serve: reply kinds {kinds} miss one")
    if bad or lost or st["submitted"] != 95:
        raise AssertionError(f"serve: {bad} mismatches, {lost} lost, "
                             f"{st['submitted']} submitted")
    if launches["q8_decode"] != hops or launches["q8_encode"] != 0:
        raise AssertionError(f"serve: launches {launches}, {hops} hops")
    return kinds


def threaded_serve(sc, state):
    """A short threaded pass through launch/serve.py's serve_campaign:
    parity and accounting (no launch counts: fetchers decode at once)."""
    from repro_torch.launch.serve import serve_campaign

    res = serve_campaign(sc, rounds=2, vehicles=200, fetchers=8,
                         codec="delta_int8", max_lag=2, queue_limit=64,
                         state=state)
    st = res["server"]
    print(f"[serve] threaded: 2 Table-1 rounds trained while 8 fetchers "
          f"issued 200 fetches: {res['served']} served, {res['shed']} shed, "
          f"{res['served_per_s']:.1f} served/s over {res['wall_s']:.2f} s, "
          f"fetch p50 {res['p50_us'] / 1e3:.3f} ms, p99 "
          f"{res['p99_us'] / 1e3:.3f} ms, batches {st['batches']}, "
          f"{res['mismatches']} mismatches, {res['lost']} lost", flush=True)
    if res["mismatches"] or res["lost"] or not res["served"]:
        raise AssertionError(f"threaded serve: {res['mismatches']} "
                             f"mismatches, {res['lost']} lost, "
                             f"{res['served']} served")


def lossless_round(dev, data, state):
    """One more round from `state` with codec="delta" and with "identity":
    the trees are bitwise equal (cuDNN held to deterministic algorithms,
    so that the two rounds' convolutions sum in the same order)."""
    import torch

    from repro_torch.convert import ravel
    from repro_torch.core.scenario import Scenario, run_round
    from repro_torch.trace_round import TABLE1

    state = state.replace(comms=None)
    trees = []
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for codec in ("delta", "identity"):
            sc = Scenario(device=dev, codec=codec, data=data, **TABLE1)
            st, _ = run_round(state, sc)
            trees.append(ravel(st.global_tree))
    finally:
        torch.backends.cudnn.deterministic = prev
    torch.cuda.synchronize()
    same = torch.equal(trees[0], trees[1])
    print(f"[comms] one round with codec=delta and with codec=identity "
          f"from round {state.round}: trees bitwise equal {same}",
          flush=True)
    if not same or torch.equal(trees[0], ravel(state.global_tree)):
        raise AssertionError("delta round is not bitwise the identity "
                             "round, or did not train")


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
    rows = kernel_phase(dev) + q8_kernels(dev)
    cross_check(dev)
    launches, main_sc, main_state = main_path(dev)
    comms_launches, sc, state, store = comms_path(dev, main_sc, main_state)
    serve_path(store)
    threaded_serve(sc, state)
    lossless_round(dev, main_sc.data, state)
    for r in rows:      # each kernel's count on the path that runs it
        r["launches"] = (comms_launches if r["name"].startswith("q8")
                         else launches)[r["name"]]
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
