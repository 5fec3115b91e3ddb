"""RSU topology — pure round orchestration over an explicit `FLState`.

Counterpart of `repro.core.topology` (`SingleRSU`, `_cohort_plan`,
`_batch_indices`, `_client_images`). Slice 1 ports `SingleRSU`, the
paper-exact Steps 2-4: one RSU, one cohort, one aggregation through the
``AGGREGATORS`` registry.

A round is split as the reference splits it:

* `_cohort_plan` makes every random draw of the round, up front: cohort
  ids and batch indices from the host MT19937 (`numpy.random.RandomState`,
  in the reference's order, so bitwise the reference's), then the
  velocities and each client's per-iteration pi1/pi2 draws from the CPU
  `torch.Generator` (in place of the reference's jax key chain), and the
  cosine lr;
* `SingleRSU.execute` runs a plan: batches, motion blur, local training,
  the codec stage (`comms.codecs.roundtrip_cohort`, which threads the
  codec's comms state), Eq.-11 aggregation, the round record.

The phases are marked with `torch.profiler.record_function` ranges
(``round.plan``, ``round.batches``, ``round.clients``, ``round.comms``,
``round.aggregate``), which `trace_round` reads from a profiled round.

So a test can hand `execute` a plan whose draws were replayed from the
reference's keys.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.comms.codecs import roundtrip_cohort
from repro_torch.convert import tree_map
from repro_torch.core import aggregation as agg
from repro_torch.core import ssl
from repro_torch.core.clients import CLIENT_UPDATES
from repro_torch.core.mobility import apply_motion_blur
from repro_torch.core.state import (FLState, generator_from, pack_host_rng,
                                    unpack_host_rng)


@dataclass(frozen=True)
class CohortPlan:
    """Every random choice of one round, made before any training.

    ids         (n,) vehicle ids (host RNG)
    batch_idx   n arrays of cfg.batch_size indices into each vehicle's data
    velocities  (n,) float32 CPU tensor (Eq. 1)
    lr          this round's learning rate (a float32 value)
    draws       per client, per local iteration, a (pi1, pi2) draw pair
    """

    ids: np.ndarray
    batch_idx: list
    velocities: torch.Tensor
    lr: float
    draws: list


def _batch_indices(rng, data_len: int, cfg) -> np.ndarray:
    """One client's batch indices from the host RNG; small clients sample
    with replacement."""
    return rng.choice(data_len, size=cfg.batch_size,
                      replace=data_len < cfg.batch_size)


def _cohort_plan(rng: np.random.RandomState, gen: torch.Generator, rnd: int,
                 scenario) -> CohortPlan:
    """Draw one round's plan; advances `rng` and `gen`."""
    cfg = scenario.cfg
    ids = rng.choice(cfg.n_vehicles, size=cfg.vehicles_per_round,
                     replace=False)
    batch_idx = [_batch_indices(rng, len(scenario.data[c]), cfg) for c in ids]
    velocities = scenario.mobility.sample(gen, len(ids))
    b = cfg.batch_size
    draws = [[(ssl.draw_pi1(gen, b), ssl.draw_pi2(gen, b))
              for _ in range(cfg.local_iters)] for _ in ids]
    return CohortPlan(ids=ids, batch_idx=batch_idx, velocities=velocities,
                      lr=scenario.lr_fn(rnd), draws=draws)


def _client_images(scenario, cid: int, idx, velocity, device) -> torch.Tensor:
    """One client's batch, motion-blurred by its velocity (no RNG)."""
    images = torch.from_numpy(scenario.data[cid][idx]).to(device)
    if scenario.blur_images:
        images = apply_motion_blur(images, velocity,
                                   scenario.mobility.camera_const)
    return images


class SingleRSU:
    """Paper-exact FLSimCo: one RSU aggregating one sampled cohort."""

    name = "single"

    def run_round(self, state: FLState, scenario, parallel: bool = True):
        """One round: (state, scenario) -> (new state, record). `parallel`
        is accepted for the reference's signature; the port trains the
        cohort client by client either way."""
        with record_function("round.plan"):
            rng = unpack_host_rng(state.host_rng)
            gen = generator_from(state.gen_state)
            plan = _cohort_plan(rng, gen, state.round, scenario)
        tree, comms, rec = self.execute(state.global_tree, state.comms,
                                        scenario, plan, state.round)
        return state.replace(global_tree=tree, gen_state=gen.get_state(),
                             host_rng=pack_host_rng(rng),
                             round=state.round + 1, comms=comms), rec

    def execute(self, tree: dict, comms, scenario, plan: CohortPlan,
                rnd: int):
        """Run `plan` from the global `tree` and the codec's `comms` state
        on the scenario's device. Returns (new tree, new comms, record)."""
        cfg, mob, device = scenario.cfg, scenario.mobility, scenario.device
        with record_function("round.batches"):
            tree = tree_map(lambda t: t.to(device), tree)
            batches = [_client_images(scenario, c, idx, v, device)
                       for c, idx, v in zip(plan.ids, plan.batch_idx,
                                            plan.velocities)]
            draws = [[(ssl.draws_to(d1, device), ssl.draws_to(d2, device))
                      for d1, d2 in client] for client in plan.draws]
            v = plan.velocities.to(device)
        with record_function("round.clients"):
            cohort = CLIENT_UPDATES[cfg.client].run_cohort(
                cfg, tree, batches, draws, plan.lr)
            cohort = cohort.with_stats(velocities=v, blur=mob.blur_level(v))
        # comms tier: the RSU aggregates what survived the V2I link
        # (encode -> decode against the broadcast base model); identity
        # passes the cohort through, the lossless delta codec is bitwise
        with record_function("round.comms"):
            cohort, comms = roundtrip_cohort(cfg, cohort, tree, comms)
        with record_function("round.aggregate"):
            new_tree = agg.AGGREGATORS[cfg.aggregator](cohort, cfg)
        losses = cohort.valid_losses.cpu().numpy().astype(np.float64)
        rec = {"round": rnd, "loss": float(np.mean(losses)),
               "velocities": plan.velocities.tolist(), "lr": plan.lr,
               "topology": self.name}
        return new_tree, comms, rec


TOPOLOGIES = {"single": SingleRSU}
