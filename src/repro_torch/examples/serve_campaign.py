"""Train-and-serve in one process: the RSU deployment loop end to end.

`run_campaign(publish=store.publish)` is the learner — each chunk's new
global model becomes an immutable `ModelStore` snapshot, delta-encoded
once through the `CODECS` registry (``--codec delta_int8``: the q8
kernels). `RSUServer` is the distribution actor — fetcher threads
simulate vehicles pulling models WHILE the campaign trains, applying
delta chains (or the full-tree staleness fallback) and verifying every
decoded tree is bitwise equal to a published snapshot. Checks on the
spot:

  * every fetch resolves exactly once (served or shed-with-retry-after,
    never lost);
  * decoded trees match the published snapshots bit for bit;
  * the campaign captures at most one graph (`compile_counts` against
    `analysis.guards.ENGINE_COMPILE_BOUNDS`): publishing rides the
    once-per-chunk history fetch.

The vehicles start fetching at the campaign's first publish: on the card
that round captures the CUDA graph, and a capture admits no other
thread's work on the card (nothing newer than round 0 exists before it).
Counterpart of `examples/serve_campaign.py`.

    PYTHONPATH=src python -m repro_torch.examples.serve_campaign \\
        [--rounds 4] [--codec delta_int8] [--device cpu]
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from repro_torch.analysis.guards import assert_compile_bounds
from repro_torch.convert import leaves_with_paths
from repro_torch.core.engine import compile_counts
from repro_torch.core.scenario import Scenario, run_campaign
from repro_torch.examples.common import device_of, parser
from repro_torch.serve import ModelStore, RSUServer, ServePolicy, apply_reply

FETCH_S = 60.0


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for (_, x), (_, y) in
               zip(leaves_with_paths(a), leaves_with_paths(b)))


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--fetchers", type=int, default=4)
    ap.add_argument("--codec", default="delta")
    args = ap.parse_args(argv)
    device = device_of(args)

    print("== FLSimCo train-and-serve ==")
    rs = np.random.RandomState(0)
    data = [rs.rand(6, 4, 4, 3).astype(np.float32) for _ in range(8)]
    sc = Scenario(topology="single", data=data, n_vehicles=8,
                  vehicles_per_round=3, batch_size=2, rounds=args.rounds,
                  local_iters=1, lr=0.4, seed=7, device=device)

    store = ModelStore(codec=args.codec, window=args.rounds + 2)
    state0 = sc.init_state()
    store.publish(state0.round, state0.global_tree)
    server = RSUServer(store, ServePolicy(max_lag=4))
    first_publish, failed = threading.Event(), threading.Event()
    results, errors = [], []

    def publish(rnd, tree):
        store.publish(rnd, tree)
        first_publish.set()

    def vehicle(seed):
        vrs = np.random.RandomState(seed)
        have_round = 0
        have_tree = store.get(0).served_tree
        fetched, mismatches = 0, 0
        deadline = time.perf_counter() + FETCH_S
        first_publish.wait(timeout=FETCH_S)
        while time.perf_counter() < deadline and not failed.is_set():
            rep = server.submit(have_round).result(timeout=30.0)
            if rep.status == "shed":
                time.sleep(rep.retry_after_s)
                continue
            have_tree = apply_reply(rep, have_tree, codec=args.codec)
            have_round = rep.round
            fetched += 1
            snap = store.get(rep.round)
            if snap is not None and not _equal(have_tree, snap.served_tree):
                mismatches += 1
            if have_round >= state0.round + args.rounds:
                break
            time.sleep(0.001 * vrs.rand())
        results.append({"fetched": fetched, "mismatches": mismatches})

    def guarded(seed):
        try:
            vehicle(seed)
        except Exception as e:   # reported by the main thread after join
            errors.append(e)

    threads = [threading.Thread(target=guarded, args=(i,))
               for i in range(args.fetchers)]
    for t in threads:
        t.start()
    try:
        state, hist = run_campaign(sc, state0, publish=publish,
                                   publish_every=1)
    except BaseException:
        failed.set()
        raise
    finally:
        first_publish.set()
        for t in threads:
            t.join(timeout=FETCH_S + 30.0)
        server.stop()
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise AssertionError("a fetcher thread did not finish")

    fetched = sum(r["fetched"] for r in results)
    mism = sum(r["mismatches"] for r in results)
    st = server.stats()
    lost = st["submitted"] - st["served"] - st["shed"]
    if mism:
        raise AssertionError(f"{mism} decode mismatches")
    if lost:
        raise AssertionError(f"{lost} lost requests")
    if not all(r["fetched"] > 0 for r in results):
        raise AssertionError(f"a vehicle fetched nothing: {results}")
    print(f"{args.fetchers} vehicles fetched {fetched} models over "
          f"{len(hist)} trained rounds (codec={args.codec}); "
          f"decode parity bitwise OK, 0 lost")

    counts = compile_counts(sc)
    assert_compile_bounds(counts, what="train-and-serve campaign")
    print(f"compile bounds with publish hook: {counts}: OK")
    print(f"store: {store.stats()}, server: {st}")
    print("OK")
    return {"fetched": fetched, "mismatches": mism, "lost": lost,
            "rounds": len(hist), "final_round": state.round,
            "server": st, "store": store.stats(),
            "compile_counts": counts}


if __name__ == "__main__":
    main()
