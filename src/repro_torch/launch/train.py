"""Training driver — counterpart of `repro.launch.train` (`run_sim`,
`main`).

Two modes, as the reference's:

``--mode mesh`` (default) — the zoo's federated train step
(`launch.steps.make_train_step`: the blur-weighted LM loss or the
token-view DT objective). At world size 1 without
``--model-parallel`` it runs on one card, the device the params lie
on. Under ``torchrun --nproc-per-node N`` (or with
``--model-parallel M``) it runs on the zoo mesh (launch/mesh.py
`zoo_mesh`: ("data", "model") = (N / M, M), or with ``--multi-pod``
("pod", "data", "model") = (2, N / 2M, M)), one rank a card (gloo
ranks with ``--device cpu``): every rank draws the same params and
batches from ``--seed``, keeps its shards (launch/sharding.py) and
runs the sharded step; rank 0 prints. The mesh steps take every
zoo family (`steps.MESH_FAMILIES`); the params are drawn whole on every
rank and sliced (`steps.shard_params`), so a model runs on the mesh
only where one rank holds all of it (sharded initialisation is ROADMAP
Queue A, item 12's next mesh bullet). ``--reduced`` is
the reference's CPU run: the ``-smoke`` config in float32, 4 sequences
of 64 tokens a step (its ``InputShape("cpu", 64, 4, "train")``).
Without it the full-width config runs real steps on the card with
bfloat16 parameters and momentum at ``--batch`` sequences of
``--seq-len`` tokens in ``--n-micro`` micro-batches (the reference's
``train_4k``, 256 x 4096, is a multi-pod shape). Weights are random,
from ``--seed``; tokens and blur come from CPU generators, the blur
through `MobilityModel`.

    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --device cpu --steps 2 --objective lm
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \\
        --batch 8 --seq-len 4096 --steps 3                 # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
        --reduced --device cpu --steps 2 --objective dt
    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \\
        --batch 8 --seq-len 4096 --n-micro 8 --steps 2     # on the card
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch seamless-m4t-large-v2 --batch 8 --seq-len 4096 \\
        --n-micro 8 --steps 2                              # on the card
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch llama-3.2-vision-90b --reduced --device cpu --steps 2

Full-width llama-3.2-vision-90b (9.07e10 parameters, 181 GB in bf16)
does not fit one card; chip_smoke.py trains it with n_layers cut to 2.

The mesh mode on 8 gloo ranks of the CPU, model-parallel over 4:

    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \
        --arch olmoe-1b-7b --reduced --device cpu --model-parallel 4
    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \
        --arch hymba-1.5b --reduced --device cpu --model-parallel 4 \
        --batch 8

``--mode sim`` — the host-level FL simulation, a `Scenario` driven
through `run_round`, with whole-`FLState` checkpoints and resume:

    PYTHONPATH=src python -m repro_torch.launch.train --mode sim \\
        --topology multi --rounds 4 --vehicles 8 --ckpt-dir ckpt --resume

Under ``torchrun --nproc-per-node N`` every rank runs the same rounds,
MultiRSU over its cohort mesh (launch/mesh.py; gloo ranks with
``--device cpu``, one card a rank on CUDA), and rank 0 prints and
writes the checkpoints:

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --mode sim --topology multi --per-round 4 --device cpu

Each step or round prints its loss and seconds and fails on a loss that
is not finite; on the card the run ends with its peak device memory.
"""
from __future__ import annotations

import argparse
import math
import os
import time

import torch
import torch.distributed as dist

from repro_torch.configs.base import InputShape, get_config
from repro_torch.core.mobility import MobilityModel
from repro_torch.launch import steps as st
from repro_torch.launch.decode import init_model
from repro_torch.runtime import set_parity_mode

REDUCED_SHAPE = InputShape("cpu", 64, 4, "train")


def run_sim(a) -> None:
    """Scenario-driven FL simulation with FLState checkpointing."""
    from repro_torch.checkpoint.store import latest, restore_state, save_state
    from repro_torch.core.scenario import Scenario, run_round
    from repro_torch.launch.mesh import init_from_launcher

    device = init_from_launcher(a.device)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    sc = Scenario(topology=a.topology, aggregator=a.aggregation,
                  client=a.client, partitioner=a.partitioner,
                  n_per_class=a.n_per_class,
                  n_vehicles=a.vehicles, vehicles_per_round=a.per_round,
                  batch_size=a.batch, rounds=a.rounds, lr=a.sim_lr,
                  device=device)
    state = None
    if a.resume and a.ckpt_dir:
        found = latest(a.ckpt_dir)
        if found:
            state = restore_state(found[0], scenario=sc)
            print(f"resumed FLState from {found[0]} (round {state.round})")
    if state is None:
        state = sc.init_state()
    if lead:
        ranks = dist.get_world_size() if dist.is_initialized() else 1
        print(f"sim {sc.topology.name} agg={sc.cfg.aggregator} "
              f"client={sc.cfg.client} vehicles={sc.cfg.n_vehicles} "
              f"rounds={sc.cfg.rounds} ranks={ranks}")
    while state.round < sc.cfg.rounds:
        t0 = time.time()
        state, rec = run_round(state, sc)
        if lead:
            print(f"round {rec['round']}: loss={rec['loss']:.4f} "
                  f"({time.time() - t0:.2f}s)")
        if not math.isfinite(rec["loss"]):
            raise SystemExit(f"round {rec['round']}: loss is not finite")
        if a.ckpt_dir and lead:
            save_state(os.path.join(a.ckpt_dir, f"ckpt_{state.round}.npz"),
                       state, scenario=sc)


def make_batch(cfg, shape: InputShape, step: int, seed: int, device,
               objective: str, mob: MobilityModel | None = None) -> dict:
    """Step `step`'s batch: tokens (B, S) in [1, vocab_size) and blur (B,)
    (`MobilityModel` velocities through Eq. 2), from a CPU generator
    seeded with (seed, step); for the ``audio`` family also the frame
    embeddings (B, max(S // 4, 8), d_audio), for the ``vlm`` family the
    patch embeddings (B, n_vision_tokens, d_vision), standard normal
    float32, as the reference's; for ``dt`` also the two views' drop
    masks.
    Everything is drawn first, then moved to `device`."""
    gen = torch.Generator().manual_seed(seed * 1_000_003 + step)
    b, s = shape.global_batch, shape.seq_len
    mob = mob or MobilityModel()
    batch = {"tokens": torch.randint(1, cfg.vocab_size, (b, s),
                                     generator=gen),
             "blur": mob.blur_level(mob.sample(gen, b))}
    if cfg.family == "audio":
        batch["frames"] = torch.randn(st.frames_shape(cfg, b, s),
                                      generator=gen)
    if cfg.family == "vlm":
        batch["patches"] = torch.randn(st.patches_shape(cfg, b),
                                       generator=gen)
    if objective == "dt":
        batch["drops"] = st.draw_drop_masks((b, s), gen)
    return {k: v.to(device) for k, v in batch.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_steps(step_fn, params, mom, batches, device):
    """Apply `step_fn` to each batch in turn. Returns (params, mom,
    [(loss, seconds)]), each step timed on the host clock, synchronised."""
    out = []
    for batch in batches:
        _sync(device)
        t0 = time.perf_counter()
        params, mom, metrics = step_fn(params, mom, batch)
        loss = float(metrics["loss"])
        out.append((loss, time.perf_counter() - t0))
    return params, mom, out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="mesh", choices=["mesh", "sim"])
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--objective", default="lm", choices=["lm", "dt"])
    ap.add_argument("--aggregation", default="flsimco",
                    choices=["flsimco", "fedavg", "discard"])
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--multi-pod", action="store_true",
                    help="mesh: two pods, (pod, data, model)")
    ap.add_argument("--model-parallel", type=int, default=None,
                    help="mesh: ranks a model-parallel group (the mesh's "
                         "model axis); given, the zoo mesh runs even at "
                         "world size 1")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="tokens a sequence (default: 64 reduced, 4096)")
    ap.add_argument("--n-micro", type=int, default=None,
                    help="micro-batches a step (default: the reference's "
                         "pick_n_micro reduced; one sequence each at full "
                         "width, since the port keeps every layer's "
                         "activations where the reference remats them)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    # --mode sim knobs (Scenario fields); --batch is also mesh's batch
    ap.add_argument("--topology", default="single",
                    choices=["single", "multi", "handover"])
    ap.add_argument("--client", default="dtssl", choices=["dtssl", "fedco"])
    ap.add_argument("--partitioner", default="iid",
                    choices=["iid", "dirichlet"])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--vehicles", type=int, default=6)
    ap.add_argument("--per-round", type=int, default=2)
    ap.add_argument("--batch", type=int, default=None,
                    help="sim: images a client batch (default 16); mesh: "
                         "sequences a step (default: 4 reduced, 8)")
    ap.add_argument("--n-per-class", type=int, default=40)
    ap.add_argument("--sim-lr", type=float, default=0.5)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--resume", action="store_true")
    a = ap.parse_args(argv)

    if a.mode == "sim":
        a.batch = a.batch or 16
        run_sim(a)
        return
    cfg = get_config(a.arch)
    device, mesh = st.launch_zoo_mesh(a.device, a.model_parallel,
                                      a.multi_pod)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    set_parity_mode()
    if a.reduced:
        cfg = cfg.reduced()
        dtype = torch.float32
        shape = InputShape("cpu", a.seq_len or REDUCED_SHAPE.seq_len,
                           a.batch or REDUCED_SHAPE.global_batch, "train")
    else:
        dtype = torch.bfloat16
        shape = InputShape("card", a.seq_len or 4096, a.batch or 8, "train")
    n_micro = a.n_micro or (None if a.reduced else shape.global_batch)
    fn, nm = st.make_train_step(cfg, shape, mesh, objective=a.objective,
                                lr=a.lr, aggregation=a.aggregation,
                                n_micro=n_micro)
    where = device if mesh is None else (
        f"the {dict(zip(mesh.mesh_dim_names, mesh.shape))} mesh of "
        f"{device.type} ranks")
    if lead:
        print(f"train {cfg.name} on {where}: {shape.global_batch} x "
              f"{shape.seq_len} tokens a step, micro={nm} "
              f"objective={a.objective} agg={a.aggregation}")
    params = init_model(cfg, a.seed, dtype, device)
    if mesh is not None:
        params = st.shard_params(cfg, params, mesh)
    mom = st.init_momentum(params)
    mob = MobilityModel()
    tokens = shape.global_batch * shape.seq_len
    for i in range(a.steps):
        batch = make_batch(cfg, shape, i, a.seed, device, a.objective, mob)
        params, mom, [(loss, secs)] = run_steps(fn, params, mom, [batch],
                                                device)
        if lead:
            print(f"step {i}: loss={loss:.4f} ({secs:.2f}s, "
                  f"{tokens / secs:.0f} tok/s)")
        if not math.isfinite(loss):
            raise SystemExit(f"step {i}: loss is not finite")
    if device.type == "cuda" and lead:
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        print(f"peak memory {peak:.2f} GiB "
              f"({torch.cuda.get_device_name(device)})")


if __name__ == "__main__":
    main()
