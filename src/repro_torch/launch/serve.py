"""FL train-and-serve launcher: one process trains and serves the fleet.

Counterpart of `repro.launch.serve`. The learner is
``run(sc, state, publish=store.publish)`` (the port has no compiled
engine; the reference's eager `run` has the same hook), publishing one
snapshot per round into a `ModelStore`; `RSUServer` is the distribution
actor answering concurrent vehicle fetches with batched replies (delta
chains through the `CODECS` registry, full-tree staleness fallback) and
admission control.

Fetcher threads simulate the fleet while the campaign trains: each
vehicle holds some already fetched round, submits a fetch, applies the
reply, and checks that its tree is BITWISE the snapshot the server
reconstructs (``torch.equal`` on the flat rows). Exits non-zero if a
request is lost or a decode mismatches.

  PYTHONPATH=src python -m repro_torch.launch.serve --rounds 6 --vehicles 200
  PYTHONPATH=src python -m repro_torch.launch.serve --codec delta_int8 \\
      --max-lag 2 --queue-limit 64        # exercise full fallback + shed

Runs on CUDA unless ``--device cpu``. `serve_campaign` is the body, for
callers that bring their own `Scenario` (chip_smoke.py runs it at the
paper's Table-1 size).
"""
from __future__ import annotations

import argparse
import threading
import time

import numpy as np
import torch

from repro_torch.convert import ravel
from repro_torch.core.scenario import Scenario, run
from repro_torch.serve import ModelStore, RSUServer, ServePolicy, apply_reply


def _trees_equal(a, b) -> bool:
    return torch.equal(ravel(a), ravel(b))


def _fetch_worker(server, store, codec, n_fetches, seed, out):
    rs = np.random.RandomState(seed)
    lat_us, mism, shed, served = [], 0, 0, 0
    have_round, have_tree = None, None
    for _ in range(n_fetches):
        rounds = store.rounds()
        if not rounds:
            time.sleep(0.001)
            continue
        if have_round is None or rs.rand() < 0.2:
            # (re)join the fleet at a random already published round
            have_round = int(rs.choice(rounds))
            have_tree = store.get(have_round)
            have_tree = (None if have_tree is None
                         else have_tree.served_tree)
        pend = server.submit(have_round if have_tree is not None else -1)
        rep = pend.result(timeout=60.0)
        lat_us.append((time.perf_counter() - pend.t_submit) * 1e6)
        if rep.status == "shed":
            shed += 1
            time.sleep(rep.retry_after_s)
            continue
        served += 1
        have_tree = apply_reply(rep, have_tree, codec=codec)
        have_round = rep.round
        snap = store.get(rep.round)
        if snap is not None and not _trees_equal(have_tree,
                                                 snap.served_tree):
            mism += 1
    out.append({"lat_us": lat_us, "mismatches": mism, "shed": shed,
                "served": served})


def serve_campaign(sc: Scenario, *, rounds: int, vehicles: int = 200,
                   fetchers: int = 8, codec: str = "delta",
                   max_lag: int = 4, queue_limit: int = 4096,
                   window: int = 16, state=None) -> dict:
    """Train `rounds` rounds of `sc` from `state` (default its round-0
    state) while `fetchers` threads issue `vehicles` fetches in all
    against an `RSUServer` over a ``ModelStore(codec, window)``. Returns
    the final state, the store, and the fleet's accounting: served,
    shed, mismatches, lost, wall_s, served_per_s, p50_us and p99_us of
    the fetch latency, and the server's stats."""
    store = ModelStore(codec=codec, window=window)
    state0 = sc.init_state() if state is None else state
    store.publish(state0.round, state0.global_tree)   # bootstrap snapshot
    server = RSUServer(store, ServePolicy(max_lag=max_lag,
                                          queue_limit=queue_limit))
    per = max(1, vehicles // fetchers)
    out: list = []
    threads = [threading.Thread(target=_fetch_worker,
                                args=(server, store, codec, per, 100 + i,
                                      out))
               for i in range(fetchers)]
    t0 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        state, _ = run(sc, state0, rounds=rounds, publish=store.publish)
    finally:
        for t in threads:
            t.join(timeout=600.0)
        server.stop()
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise RuntimeError("fetcher threads did not finish")
    if len(out) != fetchers:
        raise RuntimeError(f"{fetchers - len(out)} fetcher threads failed")
    lat = np.concatenate([np.asarray(o["lat_us"]) for o in out])
    served = sum(o["served"] for o in out)
    st = server.stats()
    return {"state": state, "store": store, "served": served,
            "shed": sum(o["shed"] for o in out),
            "mismatches": sum(o["mismatches"] for o in out),
            "lost": st["submitted"] - st["served"] - st["shed"],
            "wall_s": wall, "served_per_s": served / wall,
            "p50_us": float(np.percentile(lat, 50)),
            "p99_us": float(np.percentile(lat, 99)), "server": st}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--vehicles", type=int, default=200,
                    help="total fetches issued across the fleet")
    ap.add_argument("--fetchers", type=int, default=8,
                    help="client threads simulating the fleet")
    ap.add_argument("--codec", default="delta",
                    choices=["identity", "delta", "delta_int8"])
    ap.add_argument("--max-lag", type=int, default=4)
    ap.add_argument("--queue-limit", type=int, default=4096)
    ap.add_argument("--window", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    a = ap.parse_args(argv)

    rs = np.random.RandomState(0)
    data = [rs.rand(6, 4, 4, 3).astype(np.float32) for _ in range(8)]
    sc = Scenario(topology="single", data=data, n_vehicles=8,
                  vehicles_per_round=3, batch_size=2, rounds=a.rounds,
                  local_iters=1, lr=0.4, seed=11, device=a.device)
    res = serve_campaign(sc, rounds=a.rounds, vehicles=a.vehicles,
                         fetchers=a.fetchers, codec=a.codec,
                         max_lag=a.max_lag, queue_limit=a.queue_limit,
                         window=a.window)
    st = res["server"]
    print(f"trained {a.rounds} rounds on {sc.device}; published "
          f"{res['store'].stats()['publishes']} snapshots (codec={a.codec})")
    print(f"served {res['served']} fetches ({res['shed']} shed) from "
          f"{a.fetchers} fetchers in {res['wall_s']:.2f}s "
          f"-> {res['served_per_s']:.0f} models/s")
    print(f"fetch latency p50 {res['p50_us']:.0f} us, "
          f"p99 {res['p99_us']:.0f} us; batches={st['batches']} "
          f"groups={st['groups']} max_depth={st['max_depth']}")
    print(f"decode parity: {res['mismatches']} mismatches; lost requests: "
          f"{res['lost']}")
    if res["mismatches"] or res["lost"]:
        raise SystemExit("FAIL: serve parity/accounting violated")
    if res["state"].round != a.rounds:
        raise SystemExit(f"FAIL: trained to round {res['state'].round}, "
                         f"expected {a.rounds}")
    print("OK")


if __name__ == "__main__":
    main()
