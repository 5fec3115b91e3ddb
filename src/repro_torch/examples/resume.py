"""Checkpoint/resume demo and smoke check: pause-at-round-k is free.

Runs the same `Scenario` twice — once straight through, once saving the
full `FLState` at round k, restoring it from disk, and continuing — and
verifies the two end states agree (model, RNG streams, and round
records all live in the state, so resuming loses nothing): bit for bit
on the CPU. On the card, where runs are not bitwise repeatable, the
restored state is bitwise the saved one, the schedule, host_rng and
gen_state are bitwise the straight run's, and the trees after the pause
within the card's bound of the same rounds continued in memory from the
saved state. Exits non-zero on any mismatch. Counterpart of `examples/resume.py`.

    PYTHONPATH=src python -m repro_torch.examples.resume --rounds 4 \\
        --save-at 2 [--topology single|multi|handover] [--device cpu]
"""
from __future__ import annotations

import os
import sys
import tempfile

from repro_torch.checkpoint.store import restore_state, save_state
from repro_torch.core.scenario import Scenario, run
from repro_torch.examples.common import (CARD_LOSS_TOL, CARD_MAX_ABS,
                                         bitwise, device_of, parser,
                                         sans_loss, state_gap)

TOPOLOGY_KWARGS = {"handover": {"n_rsus": 2, "rsu_range": 300.0,
                                "round_duration": 30.0, "sync_every": 2},
                   "multi": {"n_rsus": 2}}


def scenario(topology: str, rounds: int, device=None) -> Scenario:
    return Scenario(topology=topology,
                    topology_kwargs=TOPOLOGY_KWARGS.get(topology, {}),
                    partitioner="iid", n_per_class=30,
                    n_vehicles=6, vehicles_per_round=2, batch_size=16,
                    rounds=rounds, lr=0.5, device=device)


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--save-at", type=int, default=2)
    ap.add_argument("--topology", default="single")
    a = ap.parse_args(argv)
    if not 0 < a.save_at < a.rounds:
        ap.error("--save-at must fall inside --rounds")
    device = device_of(a)
    sc = scenario(a.topology, a.rounds, device)

    print(f"straight run: {a.rounds} rounds of {a.topology}")
    straight, hist_straight = run(sc, rounds=a.rounds)

    print(f"paused run: {a.save_at} rounds + save + restore + "
          f"{a.rounds - a.save_at} rounds")
    mid, hist_a = run(sc, rounds=a.save_at)
    with tempfile.TemporaryDirectory() as d:
        path = save_state(os.path.join(d, f"ckpt_{mid.round}.npz"), mid)
        print(f"  saved FLState at round {mid.round} "
              f"({os.path.getsize(path)/1e6:.1f} MB), restoring...")
        resumed_state = restore_state(path, device=sc.device)
    restored_exact = bitwise(mid, resumed_state)
    rest = a.rounds - a.save_at
    resumed, hist_b = run(sc, resumed_state, rounds=rest)
    hist = hist_a + hist_b

    exact = bitwise(straight, resumed) and hist_straight == hist
    # the card: the rounds after the pause held against the same rounds
    # continued in memory from the saved state (runs on the card are not
    # bitwise repeatable, and a difference compounds over rounds); the
    # straight run's schedule and host leaves bitwise
    continued, hist_c = run(sc, mid, rounds=rest)
    gap, unequal = state_gap(continued, resumed)
    unequal += state_gap(straight, resumed)[1]
    loss_gap = max(abs(x["loss"] - y["loss"])
                   for x, y in zip(hist_c, hist_b))
    ok = exact or (device.type == "cuda" and restored_exact and not unequal
                   and sans_loss(hist_straight) == sans_loss(hist)
                   and gap <= CARD_MAX_ABS and loss_gap <= CARD_LOSS_TOL)
    if not ok:
        print(f"MISMATCH: restored bitwise {restored_exact}, leaves "
              f"{unequal} differ, card leaves max abs {gap:.3e}, history "
              f"equal: {hist_straight == hist}")
        sys.exit(1)
    losses = [f"{h['loss']:.4f}" for h in hist_straight]
    print(f"losses: {losses}")
    if exact:
        print("resume is bit-identical to the uninterrupted run ✓")
    else:
        print(f"resume: restored state bitwise, schedule and RNG streams "
              f"bitwise, trees within {gap:.3e} of the rounds continued "
              f"from the saved state (bound {CARD_MAX_ABS}) ✓")
    return {"losses": [h["loss"] for h in hist_straight], "bitwise": exact,
            "restored_bitwise": restored_exact, "max_abs": gap,
            "loss_gap": loss_gap}


if __name__ == "__main__":
    main()
