"""Handover demo: vehicles crossing RSU boundaries mid-training.

Declares a `HandoverMultiRSU` scenario on the synthetic vehicular world
and narrates each round: which RSU every participant downloaded from,
where it ended up uploading, which uploads were discounted as stale, and
when the regional server re-synchronized the RSU models. All motion
state (positions, per-RSU models, sync stats) lives in `FLState.topo`.
Counterpart of `examples/handover.py`.

    PYTHONPATH=src python -m repro_torch.examples.handover [--device cpu]
"""
from __future__ import annotations

import numpy as np

from repro_torch.convert import leaves_with_paths
from repro_torch.core.scenario import Scenario, run_round
from repro_torch.examples.common import device_of, parser


def scenario(device=None) -> Scenario:
    """The demo's three-RSU ring on `device`."""
    return Scenario(topology="handover",
                    topology_kwargs={"n_rsus": 3, "rsu_range": 500.0,
                                     "round_duration": 12.0,
                                     "stale_discount": 0.5, "sync_every": 3},
                    aggregator="flsimco", partitioner="dirichlet", alpha=0.1,
                    n_per_class=60, min_per_client=40,
                    n_vehicles=8, vehicles_per_round=4, batch_size=32,
                    rounds=6, local_iters=1, lr=0.5, device=device)


def main(argv=None) -> dict:
    a = parser(__doc__).parse_args(argv)
    device = device_of(a)
    print("== FLSimCo multi-RSU handover demo ==")
    sc = scenario(device)
    topo = sc.topology
    print(f"road: ring of {topo.road_length:.0f} m, "
          f"{topo.n_rsus} RSUs x {topo.rsu_range:.0f} m coverage, "
          f"{sc.cfg.n_vehicles} vehicles\n")

    state = sc.init_state()
    history = []
    for _ in range(sc.cfg.rounds):
        pos_before = np.asarray(state.topo["positions"])
        state, rec = run_round(state, sc)
        history.append(rec)
        # unwrap across the ring boundary: forward distance, not raw delta
        moved = (np.asarray(state.topo["positions"])
                 - pos_before) % topo.road_length
        print(f"round {rec['round']}: loss={rec['loss']:.4f}  "
              f"uploads/RSU={rec['rsu_sizes']}  "
              f"handovers={rec['n_handovers']}"
              + ("  [region sync]" if rec["synced"] else ""))
        v = np.asarray(rec["velocities"])
        print(f"  velocities: {np.round(v * 3.6, 1).tolist()} km/h; "
              f"fleet moved {moved.min():.0f}-{moved.max():.0f} m")
    view = topo.region_view(state)  # evaluation snapshot (merged RSU models)
    n_params = sum(leaf.numel() for _, leaf in leaves_with_paths(view))
    n_total = sum(h["n_handovers"] for h in history)
    print(f"\nregion model snapshot: {n_params:,} parameters "
          f"merged from {topo.n_rsus} RSUs")
    print(f"done — {n_total} handovers across {sc.cfg.rounds} rounds; "
          f"stale uploads were down-weighted x{topo.stale_discount}, "
          f"region re-synced every {topo.sync_every} rounds.")
    return {"rounds": [{k: h[k] for k in ("round", "loss", "rsu_sizes",
                                          "n_handovers", "synced")}
                       for h in history],
            "handovers": n_total, "view_params": n_params}


if __name__ == "__main__":
    main()
