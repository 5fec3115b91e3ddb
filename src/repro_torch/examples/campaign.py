"""Campaign: the whole round loop as pre-drawn schedules plus one round
body a round, eager or replayed from one CUDA graph (core/engine.py).

Runs the SAME scenario through the eager loop and `run_campaign`
(``mode="auto"``: a CUDA graph on the card, eager on the CPU), then
checks the engine contract on the spot:

  * the pre-drawn schedule (cohort velocities, lr, every record field
    except the loss), host_rng, gen_state and the positions are bitwise
    the eager loop's;
  * chunked execution (checkpoint_every=2) against the uninterrupted
    campaign: bitwise on the CPU; on the card the schedule bitwise, and
    each chunk, run again from its checkpointed start, within the card's
    bound (runs on the card are not bitwise repeatable, and a difference
    compounds over rounds: one chunk's end is held, not the campaign's);
  * the campaign captures at most one graph (`compile_counts` against
    `analysis.guards.ENGINE_COMPILE_BOUNDS`).

Counterpart of `examples/campaign.py`.

    PYTHONPATH=src python -m repro_torch.examples.campaign [--rounds 4] \\
        [--device cpu]
"""
from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.analysis.guards import assert_compile_bounds
from repro_torch.checkpoint.store import restore_state
from repro_torch.core.engine import compile_counts
from repro_torch.core.scenario import Scenario, run, run_campaign
from repro_torch.examples.common import (bitwise, device_of, hold_losses,
                                         hold_states, parser, sans_loss)

CHUNK = 2


def scenario(rounds: int, device=None) -> Scenario:
    """A small handover world, so the round body is cheap on the CPU."""
    rs = np.random.RandomState(0)
    data = [rs.rand(16, 8, 8, 3).astype(np.float32) for _ in range(8)]
    return Scenario(topology="handover", data=data,
                    topology_kwargs={"n_rsus": 2, "rsu_range": 300.0,
                                     "round_duration": 40.0, "sync_every": 2},
                    n_vehicles=8, vehicles_per_round=3, batch_size=4,
                    rounds=rounds, local_iters=1, lr=0.4, seed=7,
                    device=device)


def _same_schedule(a, b, hist_a, hist_b) -> bool:
    return (sans_loss(hist_a) == sans_loss(hist_b)
            and torch.equal(a.gen_state, b.gen_state)
            and all(np.array_equal(a.host_rng[k], b.host_rng[k])
                    for k in a.host_rng)
            and np.array_equal(a.topo["positions"], b.topo["positions"]))


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args(argv)
    device = device_of(args)

    print("== FLSimCo campaign ==")
    sc = scenario(args.rounds, device)
    t0 = time.perf_counter()
    st_eager, hist_eager = run(sc)
    t_eager = time.perf_counter() - t0
    t0 = time.perf_counter()
    st_comp, hist_comp = run_campaign(sc, mode="auto", log_every=2)
    t_comp = time.perf_counter() - t0

    # schedule + RNG successors: bitwise vs the eager loop
    if not _same_schedule(st_eager, st_comp, hist_eager, hist_comp):
        raise AssertionError("campaign schedule differs from the eager "
                             "loop's")
    print(f"schedule bitwise vs eager: OK "
          f"({len(hist_comp)} rounds, eager {t_eager:.1f}s, "
          f"campaign {t_comp:.1f}s incl. capture)")

    # chunked against unchunked: bitwise on the CPU; chunk by chunk from
    # each chunk's checkpointed start on the card, where runs are not
    # bitwise repeatable and a difference compounds over rounds
    gaps = []
    with tempfile.TemporaryDirectory() as ckdir:
        st_ck, hist_ck = run_campaign(sc, mode="auto",
                                      checkpoint_every=CHUNK,
                                      checkpoint_dir=ckdir)
        start = sc.init_state()
        for r0 in range(0, args.rounds, CHUNK):
            k = min(CHUNK, args.rounds - r0)
            end = restore_state(os.path.join(ckdir, f"round_{r0 + k:06d}"),
                                scenario=sc)
            st_k, hist_k = run_campaign(sc, start, rounds=k, mode="auto")
            tag = f"rounds {r0}-{r0 + k - 1} from the chunk's start"
            gaps.append(hold_states(tag, end, st_k))
            hold_losses(tag, hist_ck[r0:r0 + k], hist_k, device)
            start = end
    if not (_same_schedule(st_comp, st_ck, hist_comp, hist_ck)
            and bitwise(start, st_ck)):
        raise AssertionError("chunked campaign schedule differs, or its "
                             "last checkpoint is not its final state")
    exact = bitwise(st_ck, st_comp) and hist_ck == hist_comp
    if device.type == "cpu" and not exact:
        raise AssertionError("chunked campaign is not bitwise on the CPU")
    print(f"chunked (checkpoint_every={CHUNK}) vs unchunked: OK (bitwise "
          f"{exact}; schedule bitwise; trees max abs chunk by chunk "
          f"{gaps})")

    counts = compile_counts(sc)
    assert_compile_bounds(counts, what="campaign")
    print(f"compile_counts: {counts} (bound: at most one graph capture; "
          f"handover regrouping is data, not shape)")
    print("done.")
    return {"rounds": len(hist_comp), "losses": [h["loss"]
                                                  for h in hist_comp],
            "eager_s": t_eager, "campaign_s": t_comp, "bitwise": exact,
            "chunk_gaps": gaps, "compile_counts": counts}


if __name__ == "__main__":
    main()
