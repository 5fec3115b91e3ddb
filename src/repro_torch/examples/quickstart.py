"""Quickstart: one FLSimCo experiment, two rounds, end to end.

Declares the experiment as a `Scenario` (synthetic vehicular dataset,
Dirichlet Non-IID split, blur-weighted aggregation), runs pure rounds
over an explicit `FLState`, and prints the loss and the Eq.-11 weights
that the RSU assigned to each vehicle. Counterpart of
`examples/quickstart.py`.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.aggregation import flsimco_weights
from repro_torch.core.mobility import MobilityModel
from repro_torch.core.scenario import Scenario, run_round
from repro_torch.examples.common import device_of, parser


def scenario(device=None) -> Scenario:
    """The quickstart's experiment on `device`."""
    return Scenario(topology="single", aggregator="flsimco", client="dtssl",
                    partitioner="dirichlet", alpha=0.1, n_per_class=60,
                    min_per_client=40, n_vehicles=8, vehicles_per_round=4,
                    batch_size=32, rounds=2, local_iters=1, lr=0.5,
                    device=device)


def main(argv=None) -> dict:
    a = parser(__doc__).parse_args(argv)
    device = device_of(a)
    print("== FLSimCo quickstart ==")
    sc = scenario(device)
    n_images = len(sc.dataset[0])
    print(f"dataset: {n_images} images, "
          f"{sc.cfg.n_vehicles} vehicles (Dirichlet 0.1 Non-IID)")

    state = sc.init_state()
    rounds = []
    for _ in range(sc.cfg.rounds):
        state, rec = run_round(state, sc)
        v = np.asarray(rec["velocities"], np.float32)
        w = flsimco_weights(MobilityModel().blur_level(v)).numpy()
        print(f"round {rec['round']}: DT loss = {rec['loss']:.4f}")
        for i, (vi, wi) in enumerate(zip(v, w)):
            tag = " (blurred)" if vi > 27.78 else ""
            print(f"  vehicle {i}: v = {vi*3.6:6.1f} km/h -> "
                  f"aggregation weight {wi:.3f}{tag}")
        rounds.append({"round": rec["round"], "loss": rec["loss"],
                       "velocities": v.tolist(), "weights": w.tolist()})
    print("done — faster vehicles received lower weights (Eq. 11).")
    return {"images": n_images, "vehicles": sc.cfg.n_vehicles,
            "rounds": rounds}


if __name__ == "__main__":
    main()
