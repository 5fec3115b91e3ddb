"""Mobility ablation: how velocity distribution shapes Eq.-11 weights and
convergence stability (the paper's Fig. 6 mechanism, isolated).

Sweeps the truncated-Gaussian mean velocity and reports (i) the blur-level
distribution, (ii) the aggregation-weight spread, (iii) the loss-gradient
std of short FLSimCo vs FedAvg runs at that mobility level. Velocities
come from CPU `torch.Generator`s seeded 1 and 2, where the reference
draws from jax keys 1 and 2. Counterpart of
`examples/mobility_ablation.py`.

    PYTHONPATH=src python -m repro_torch.examples.mobility_ablation \\
        --rounds 3 [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.aggregation import flsimco_weights
from repro_torch.core.federation import gradient_std
from repro_torch.core.mobility import MobilityModel
from repro_torch.core.scenario import Scenario, run
from repro_torch.data.synthetic import make_dataset, partition_iid
from repro_torch.examples.common import device_of, parser
from repro_torch.models.resnet import init_resnet

MUS = (20.0, 29.17, 38.0)


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--vehicles", type=int, default=8)
    ap.add_argument("--n-per-class", type=int, default=50)
    a = ap.parse_args(argv)
    device = device_of(a)

    # one world for the whole sweep; the Scenarios share it via data=
    x, y = make_dataset(n_per_class=a.n_per_class, seed=0)
    data = [x[p] for p in partition_iid(y, a.vehicles)]
    tree = init_resnet(get_config("resnet18-cifar"),
                       torch.Generator().manual_seed(0), device)

    out = {}
    for mu in MUS:
        mob = MobilityModel(mu=mu)
        v = mob.sample(torch.Generator().manual_seed(1), 1000).numpy()
        L = mob.blur_level(v).numpy()
        w = flsimco_weights(mob.blur_level(
            mob.sample(torch.Generator().manual_seed(2), 5))).numpy()
        print(f"\n-- mu = {mu:.1f} m/s ({mu*3.6:.0f} km/h) --")
        print(f"  blur L: mean {L.mean():.2f}, p95 {np.percentile(L,95):.2f},"
              f" frac>100km/h {(v > 27.78).mean():.2f}")
        print(f"  Eq.11 weight spread (5 vehicles): "
              f"{w.min():.3f}..{w.max():.3f}")
        row = {"blur_mean": float(L.mean()),
               "blur_p95": float(np.percentile(L, 95)),
               "frac_blurred": float((v > 27.78).mean()),
               "weight_min": float(w.min()), "weight_max": float(w.max())}
        for agg in ("flsimco", "fedavg"):
            sc = Scenario(aggregator=agg, mobility=mob, data=data,
                          global_tree=tree,
                          n_vehicles=a.vehicles, vehicles_per_round=4,
                          batch_size=32, rounds=a.rounds, lr=0.5, seed=0,
                          device=device)
            _, hist = run(sc)
            losses = [h["loss"] for h in hist]
            print(f"  {agg:8s}: losses {[f'{l:.3f}' for l in losses]} "
                  f"grad_std={gradient_std(losses):.4f}")
            row[agg] = {"losses": losses,
                        "grad_std": gradient_std(losses)}
        out[mu] = row
    return out


if __name__ == "__main__":
    main()
