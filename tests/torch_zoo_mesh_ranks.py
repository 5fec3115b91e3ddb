"""The rank program of tests/test_torch_zoo_mesh.py, and the inputs it
shares with the parent: each gloo rank imports this module alone (torch,
numpy and the port, no JAX), loads the parent's inputs (the reference's
weights as numpy, the batches), runs every case on the (data=2,
model=4) zoo mesh and, on rank 0, writes the gathered results to an npz
for the parent to compare.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import socket
import time
from datetime import timedelta
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as sh
from repro_torch.launch import steps as st
from repro_torch.models import layers as TL
from repro_torch.models import transformer as T

SPAWN_TIMEOUT_S = 240
POD_TIMEOUT_S = 900
WORLD = 8
MESH = (2, 4)                  # (data, model): tests/test_moe_ep.py's mesh
B, S = 8, 32                   # a train batch
PROMPT, N_DECODE = 30, 2       # the cache holds 32 positions
# olmoe at capacity factor 16: no assignment drops, neither in the
# expert-parallel path (capacity of each data shard's tokens) nor in the
# one-rank scatter (capacity of the whole batch), so both compute the
# same function; at the config's 1.25 they drop different assignments
CAPACITY_FACTOR = 16.0
INPUTS = "inputs.pkl"
# each model the cases run: (registry name, fields replaced in its
# reduced config). The reduced configs' 2 kv heads do not divide over
# model = 4, so their caches shard W over model; tinyllama-kv4's 4 do,
# so its cache and attention shard the heads
MODELS = {"tinyllama-1.1b": ("tinyllama-1.1b", {}),
          "olmoe-1b-7b": ("olmoe-1b-7b",
                          {"moe_capacity_factor": CAPACITY_FACTOR}),
          "tinyllama-kv4": ("tinyllama-1.1b", {"n_kv_heads": 4})}
CASES = (("tinyllama-1.1b", "lm"), ("tinyllama-1.1b", "dt"),
         ("olmoe-1b-7b", "lm"))
SERVE = tuple(MODELS)


def port_config(name: str):
    """The port's config of MODELS[name]."""
    arch, over = MODELS[name]
    return dataclasses.replace(get_config(arch + "-smoke"), **over)


def make_inputs(seed: int = 0) -> dict:
    """The batches, made with numpy from `seed`: train tokens (B, S) and
    blur (B,), prompts (B, PROMPT) and the decode tokens (N_DECODE, B, 1)."""
    rs = np.random.RandomState(seed)
    return {"tokens": rs.randint(1, 1024, (B, S)).astype(np.int32),
            "blur": rs.uniform(9.0, 25.0, B).astype(np.float32),
            "prompts": rs.randint(1, 1024, (B, PROMPT)).astype(np.int32),
            "decode": rs.randint(1, 1024, (N_DECODE, B, 1)).astype(np.int32)}


def train_batch(inputs: dict, objective: str) -> dict:
    batch = {"tokens": torch.from_numpy(inputs["tokens"].astype(np.int64)),
             "blur": torch.from_numpy(inputs["blur"])}
    if objective == "dt":
        batch["drops"] = torch.from_numpy(inputs["drops"])
    return batch


def run_steps(arch: str, np_params: dict, inputs: dict, mesh=None) -> dict:
    """Every case of `arch` from `np_params`: each train step's loss and
    updated params and momentum, the prefill's logits and each decode
    step's; on `mesh` (gathered) or on one device."""
    cfg = port_config(arch)
    out = {}
    params = convert.zoo_params_from_numpy(np_params, "cpu")
    if mesh is not None:
        params = st.shard_params(cfg, params, mesh)
    for a, objective in CASES:
        if a != arch:
            continue
        fn, _ = st.make_train_step(cfg, InputShape("t", S, B, "train"),
                                   mesh, objective=objective, n_micro=1)
        p, m, met = fn(params, st.init_momentum(params),
                       train_batch(inputs, objective))
        key = f"{arch}/{objective}"
        out[f"{key}/loss"] = met["loss"].numpy()
        for name, tree in (("params", p), ("momentum", m)):
            for path, t in convert.leaves_with_paths(sh.gather_tree(tree)):
                out[f"{key}/{name}/" + "/".join(path)] = \
                    t.detach().numpy()
    if arch in SERVE:
        total = PROMPT + N_DECODE
        shape = InputShape("p", total, B, "prefill")
        last, cache = st.make_prefill_step(cfg, shape, torch.float32,
                                           mesh=mesh)(params, {
            "tokens": torch.from_numpy(inputs["prompts"].astype(np.int64))})
        logits = [last]
        decode = st.make_decode_step(cfg, InputShape("d", total, B,
                                                     "decode"), mesh=mesh)
        for i in range(N_DECODE):
            lg, cache = decode(params, {
                "tokens": torch.from_numpy(
                    inputs["decode"][i].astype(np.int64)),
                "positions": torch.full((B,), PROMPT + i, dtype=torch.int64),
                "cache": cache})
            logits.append(lg)
        out[f"{arch}/serve_logits"] = np.stack(
            [sh.full(t).numpy() for t in logits])
    return out


def moe_ep_case(moe: dict, mesh) -> dict:
    """`moe_block_ep` on the reference's MoE weights (placed by the
    params rules under a ``moe`` key) and x (batch on data): the
    gathered output and aux."""
    cfg = port_config("olmoe-1b-7b")
    tree = {"moe": convert.zoo_params_from_numpy(moe["params"], "cpu")}
    p = sh.shard_tree(tree, mesh, sh.params_shardings(mesh, tree))["moe"]
    x = torch.from_numpy(moe["x"])
    x = sh.shard_like(x, mesh, sh.batch_spec(mesh, x.shape[0]))
    y, aux = TL.moe_block_ep(cfg, p, x)
    return {"moe/y": y.full_tensor().numpy(),
            "moe/aux": aux.full_tensor().numpy()}


def _rank_main(rank: int, world: int, port: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=SPAWN_TIMEOUT_S))
    try:
        t = time.time()
        with open(os.path.join(out_dir, INPUTS), "rb") as f:
            data = pickle.load(f)
        mesh = tmesh.zoo_mesh(*MESH, device="cpu")
        out = {"world": np.array(dist.get_world_size()),
               "mesh": np.array(mesh.shape)}
        ep = mock.patch.object(TL, "moe_block_ep",
                               side_effect=TL.moe_block_ep)
        with ep as spy:
            for arch in SERVE:
                out.update(run_steps(arch, data["params"][arch],
                                     data["inputs"], mesh))
        out["ep_calls"] = np.array(spy.call_count)
        out.update(moe_ep_case(data["moe"], mesh))
        out["seconds"] = np.array(time.time() - t)
        print(f"rank {rank}/{world}: {float(out['seconds']):.1f} s",
              flush=True)
        if rank == 0:
            np.savez(os.path.join(out_dir, "rank0.npz"), **out)
    finally:
        dist.destroy_process_group()
        tmesh.reset_meshes()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(out_dir: str, world: int = WORLD) -> dict:
    """Spawn `world` gloo ranks running `_rank_main` (fails the calling
    test if they take more than SPAWN_TIMEOUT_S); rank 0's results."""
    ctx = mp.start_processes(_rank_main,
                             args=(world, _free_port(), out_dir),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} gloo ranks did not finish in "
                        f"{SPAWN_TIMEOUT_S} s")
    return dict(np.load(os.path.join(out_dir, "rank0.npz")))


def _pod_rank_main(rank: int, world: int, port: int) -> None:
    """Every case on a (pod=2, data=2, model=2) mesh of the 8 ranks, from
    the port's own weights (seed 5), each against the one-device step."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=POD_TIMEOUT_S))
    try:
        t = time.time()
        inputs = make_inputs()
        inputs["drops"] = np.random.RandomState(3).rand(2, B, S) < 0.15
        mesh = tmesh.zoo_mesh(2, 2, 2, device="cpu")
        for arch in SERVE:
            cfg = port_config(arch)
            params = convert.zoo_params_to_numpy(
                T.init_params(cfg, torch.Generator().manual_seed(5)))
            got = run_steps(arch, params, inputs, mesh)
            want = run_steps(arch, params, inputs)
            err = max(float(np.abs(got[k].astype(np.float64) - want[k]).max())
                      for k in want)
            if rank == 0:
                print(f"{arch}: {len(want)} results on (pod=2, data=2, "
                      f"model=2), largest difference from one device "
                      f"{err:.3e}", flush=True)
        if rank == 0:
            print(f"{time.time() - t:.1f} s", flush=True)
    finally:
        dist.destroy_process_group()
        tmesh.reset_meshes()


if __name__ == "__main__":
    # the three-axis mesh by hand (DTensor's first calls on it cost about
    # two minutes of sharding propagation a rank, too slow for the suite):
    # PYTHONPATH=src python tests/torch_zoo_mesh_ranks.py
    mp.start_processes(_pod_rank_main, args=(WORLD, _free_port()),
                       nprocs=WORLD, start_method="spawn")
