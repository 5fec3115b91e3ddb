"""Where a round's time goes on the card.

    python -m repro_torch.trace_round [--rounds 2] [--codec identity]
        [--topology single|multi|handover] [--client dtssl|fedco]
        [--sequential] [--out DIR]

(with ``src`` on PYTHONPATH, on a machine with one CUDA card). Builds the
paper's Table-1 scenario (as chip_smoke.py's main path does) with the
given codec, topology (``multi``: two RSUs; ``handover``: the reference's
defaults, two RSUs of 1 km) and client, warms up, then runs one more
round under `torch.profiler` (with the batched cohort step, or client by
client under ``--sequential``) and reports:

* each phase that the topology marks with a ``round.*`` range (plan,
  batches, clients, comms, aggregate; MultiRSU and the handover mark the
  last four once per RSU group): its host time summed over its ranges,
  how many ranges, and the device span from the first kernel launched
  inside one of them to the last;
* device time by kernel and by host op, and the device's busy and idle
  share of the round's wall time;
* the profiled round's peak device memory.

Prints one JSON line, and with ``--out DIR`` also writes the profiler's
chrome trace there. All times include the profiler's own overhead.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from repro_torch.core.scenario import Scenario, run_round
from repro_torch.kernels import build

TABLE1 = dict(topology="single", client="dtssl", aggregator="flsimco",
              partitioner="dirichlet", alpha=0.1, n_per_class=5000,
              min_per_client=520, n_vehicles=95, vehicles_per_round=5,
              batch_size=512, local_iters=1)
TOPOLOGY_KWARGS = {"single": None, "multi": {"n_rsus": 2}, "handover": {}}
PHASE = "round."


def _profiled_round(sc, state, out_dir, parallel: bool = True) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        _, rec = run_round(state, sc, parallel=parallel)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, "trace_round.json"))
    # the round.* ranges appear as host ranges and as device annotations
    # (one per stream the range launched on); a phase's device span runs
    # from the first annotation's start to the last one's end
    phases, spans, intervals = {}, {}, []
    for e in prof.events():
        if not e.name.startswith(PHASE):
            if e.device_type == DeviceType.CUDA:
                intervals.append((e.time_range.start, e.time_range.end))
            continue
        ph = phases.setdefault(e.name[len(PHASE):], {})
        if e.device_type == DeviceType.CUDA:
            lo, hi = spans.get(e.name, (e.time_range.start, e.time_range.end))
            spans[e.name] = (min(lo, e.time_range.start),
                             max(hi, e.time_range.end))
            ph["device_span_ms"] = (spans[e.name][1] - spans[e.name][0]) / 1e3
        else:
            ph["host_ms"] = (ph.get("host_ms", 0.0)
                             + e.time_range.elapsed_us() / 1e3)
            ph["ranges"] = ph.get("ranges", 0) + 1
    events = prof.key_averages()
    # kernels are the device-side events; host-side aten ops carry the
    # device time of the kernels they launched as their "self" time
    # ("Command Buffer Full" marks the host waiting for room in the
    # launch queue; it is no op)
    real = [e for e in events if not e.key.startswith(PHASE)
            and e.key != "Command Buffer Full"]
    kernels = [e for e in real if e.device_type == DeviceType.CUDA]
    ops = [e for e in real if e.device_type == DeviceType.CPU
           and e.self_device_time_total > 0]
    # busy: the union of the kernels' intervals (kernels on two streams
    # may overlap, so their summed times can pass the wall time)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        busy_us += max(0.0, hi - max(lo, end))
        end = max(end, hi)

    def top(evs, n):
        evs = sorted(evs, key=lambda e: -e.self_device_time_total)[:n]
        return [{"name": e.key[:90], "count": e.count,
                 "device_ms": e.self_device_time_total / 1e3} for e in evs]

    return {"wall_s": wall, "phases": phases,
            "record": {k: v for k, v in rec.items() if k != "velocities"},
            "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "kernel_launches": sum(e.count for e in kernels),
            "top_ops": top(ops, 12), "top_kernels": top(kernels, 8)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=2,
                   help="unmeasured warm-up rounds before the profiled one")
    p.add_argument("--codec", default="identity",
                   choices=["identity", "delta", "delta_int8"])
    p.add_argument("--topology", default="single",
                   choices=sorted(TOPOLOGY_KWARGS))
    p.add_argument("--client", default="dtssl", choices=["dtssl", "fedco"])
    p.add_argument("--sequential", action="store_true",
                   help="train client by client (run_round(parallel=False))")
    p.add_argument("--out", default=None,
                   help="directory for the chrome trace (none by default)")
    args = p.parse_args(argv)
    build.build_all()
    sc = Scenario(device="cuda", **dict(
        TABLE1, codec=args.codec, topology=args.topology, client=args.client,
        topology_kwargs=TOPOLOGY_KWARGS[args.topology]))
    state = sc.init_state()
    parallel = not args.sequential
    for _ in range(args.rounds):
        state, _ = run_round(state, sc, parallel=parallel)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prof = _profiled_round(sc, state, args.out, parallel)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "codec": args.codec,
                      "topology": args.topology, "client": args.client,
                      "parallel": parallel, "profiled": prof,
                      "peak_mem_gib": torch.cuda.max_memory_allocated()
                      / 2 ** 30}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
