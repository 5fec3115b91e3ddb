"""The rank program of tests/test_torch_zoo_mesh.py and
tests/test_torch_zoo_mesh_families.py, and the inputs it shares with
the parents: each gloo rank imports this module alone (torch, numpy and
the port, no JAX), loads the parent's inputs (the reference's weights
as numpy, the batches), runs every case of its group of models (GROUPS:
the dense and MoE models, or the rwkv6, hybrid, audio and vlm families)
on the (data=2, model=4) zoo mesh and, on rank 0, writes the gathered
results to an npz for the parent to compare.
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
# the other four families at their reduced configs: rwkv6's 4 heads and
# hymba's 512 SSM channels divide over model = 4 (the rwkv6 kernel and
# the scan run on (batch, head) and (batch, di) shards); the attention
# families' 2 kv heads do not, so their caches shard W over model
FAMILY_MODELS = {a: (a, {}) for a in ("rwkv6-1.6b", "hymba-1.5b",
                                      "seamless-m4t-large-v2",
                                      "llama-3.2-vision-90b")}
FAMILY_CASES = (("rwkv6-1.6b", "lm"), ("rwkv6-1.6b", "dt"),
                ("hymba-1.5b", "lm"), ("seamless-m4t-large-v2", "lm"),
                ("llama-3.2-vision-90b", "lm"))
FAMILY_SERVE = tuple(FAMILY_MODELS)
GROUPS = {"dense": SERVE, "families": FAMILY_SERVE}   # a spawn's models
# the context inputs, the reduced configs' widths: seamless's frames
# (enc_ctx_len of S = 32 tokens: 8 rows of d_audio 64), llama-3.2-vision's
# patches (16 vision tokens of d_vision 64)
FRAMES, PATCHES = (B, 8, 64), (B, 16, 64)
# the local-shard cases on a (data=2, model=2) mesh (each half of the 8
# ranks its own): rwkv_tmix_chunked and ssm_block with a carried state
UNIT_B, UNIT_S = 4, 20


def port_config(name: str):
    """The port's config of MODELS[name] or FAMILY_MODELS[name]."""
    arch, over = {**MODELS, **FAMILY_MODELS}[name]
    return dataclasses.replace(get_config(arch + "-smoke"), **over)


def make_inputs(seed: int = 0) -> dict:
    """The batches, made with numpy from `seed`: train tokens (B, S) and
    blur (B,), prompts (B, PROMPT), the decode tokens (N_DECODE, B, 1),
    and the frames and patches (FRAMES, PATCHES) of the audio and vlm
    families, which their train and serve cases share."""
    rs = np.random.RandomState(seed)
    return {"tokens": rs.randint(1, 1024, (B, S)).astype(np.int32),
            "blur": rs.uniform(9.0, 25.0, B).astype(np.float32),
            "prompts": rs.randint(1, 1024, (B, PROMPT)).astype(np.int32),
            "decode": rs.randint(1, 1024, (N_DECODE, B, 1)).astype(np.int32),
            "frames": rs.randn(*FRAMES).astype(np.float32),
            "patches": rs.randn(*PATCHES).astype(np.float32)}


def aux_inputs(arch: str, inputs: dict) -> dict:
    """The context input of `arch`'s family, {} for the others."""
    key = {"audio": "frames", "vlm": "patches"}.get(port_config(arch).family)
    return {key: torch.from_numpy(inputs[key])} if key else {}


def train_batch(arch: str, inputs: dict, objective: str) -> dict:
    batch = {"tokens": torch.from_numpy(inputs["tokens"].astype(np.int64)),
             "blur": torch.from_numpy(inputs["blur"]),
             **aux_inputs(arch, inputs)}
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
    for a, objective in CASES + FAMILY_CASES:
        if a != arch:
            continue
        fn, _ = st.make_train_step(cfg, InputShape("t", S, B, "train"),
                                   mesh, objective=objective, n_micro=1)
        p, m, met = fn(params, st.init_momentum(params),
                       train_batch(arch, inputs, objective))
        key = f"{arch}/{objective}"
        out[f"{key}/loss"] = met["loss"].numpy()
        for name, tree in (("params", p), ("momentum", m)):
            for path, t in convert.leaves_with_paths(sh.gather_tree(tree)):
                out[f"{key}/{name}/" + "/".join(path)] = \
                    t.detach().numpy()
    if arch in SERVE + FAMILY_SERVE:
        total = PROMPT + N_DECODE
        shape = InputShape("p", total, B, "prefill")
        last, cache = st.make_prefill_step(cfg, shape, torch.float32,
                                           mesh=mesh)(params, {
            "tokens": torch.from_numpy(inputs["prompts"].astype(np.int64)),
            **aux_inputs(arch, inputs)})
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


def unit_inputs(seed: int = 7) -> dict:
    """The local-shard cases' inputs, made with numpy from `seed`: the
    port's weights of one rwkv6 time-mix and one SSM layer of the
    reduced configs (seed 3), x (UNIT_B, UNIT_S, d) times 0.5, the
    carried rwkv6 state, the SSM and conv states, and the cotangents of
    each output."""
    rs = np.random.RandomState(seed)
    gen = torch.Generator().manual_seed(3)
    rw, hy = port_config("rwkv6-1.6b"), port_config("hymba-1.5b")
    h, hd = rw.d_model // rw.rwkv_head_dim, rw.rwkv_head_dim
    di = hy.ssm_expand * hy.d_model
    d = rw.d_model

    def draw(*shape, scale=1.0):
        return (rs.randn(*shape) * scale).astype(np.float32)

    return {
        "tmix": convert.zoo_params_to_numpy(TL.init_rwkv_tmix(rw, gen)),
        "ssm": convert.zoo_params_to_numpy(TL.init_ssm(hy, gen)),
        "x": draw(UNIT_B, UNIT_S, d, scale=0.5),
        "state": draw(UNIT_B, h, hd, hd, scale=0.1),
        "x_last": draw(UNIT_B, d, scale=0.5),
        "ssm_state": draw(UNIT_B, di, hy.ssm_state, scale=0.1),
        "conv_state": draw(UNIT_B, 3, di, scale=0.5),
        "g_rwkv": draw(UNIT_B, UNIT_S, d), "g_state": draw(UNIT_B, h, hd, hd),
        "g_ssm": draw(UNIT_B, UNIT_S, d),
        "g_h": draw(UNIT_B, di, hy.ssm_state)}


def run_units(u: dict, mesh=None) -> dict:
    """`rwkv_tmix_chunked` and `ssm_block` on `u` (`unit_inputs`) with
    the carried states: the outputs, the new states and the gradients of
    the weights, x and the states for the cotangents in `u`; on `mesh`
    (the weights placed by the params rules, x on the batch, the states
    as the cache's shards; gathered) or on one device."""
    out = {}
    cases = (("rwkv", "rwkv6-1.6b", "tmix", "state",
              ("data", "model", None, None)),
             ("ssm", "hymba-1.5b", "ssm", "ssm_state",
              ("data", "model", None)))
    for tag, arch, key, skey, sspec in cases:
        cfg = port_config(arch)
        tree = {key: convert.zoo_params_from_numpy(u[key], "cpu")}
        x = torch.from_numpy(u["x"])
        state = torch.from_numpy(u[skey])
        extra = torch.from_numpy(u["x_last"] if tag == "rwkv"
                                 else u["conv_state"])
        espec = ("data", None) if tag == "rwkv" else ("data", None, "model")
        if mesh is not None:
            tree = sh.shard_tree(tree, mesh, sh.params_shardings(mesh, tree))
            x = sh.shard_like(x, mesh, ("data", None, None))
            state = sh.shard_like(state, mesh, sspec)
            extra = sh.shard_like(extra, mesh, espec)
        leaves = [t.detach().requires_grad_() for t in
                  (x, state, *(t for _, t in
                               convert.leaves_with_paths(tree[key])))]
        x, state, w = leaves[0], leaves[1], convert.unflatten(
            leaves[2:], tree[key])
        if tag == "rwkv":
            o, s_new, _ = TL.rwkv_tmix_chunked(cfg, w, x, state=state,
                                               x_last=extra)
            cot = (u["g_rwkv"], u["g_state"])
        else:
            o, (s_new, conv_new) = TL.ssm_block(cfg, w, x, state=state,
                                                conv_state=extra)
            out["ssm/conv"] = sh.full(conv_new).detach().numpy()
            cot = (u["g_ssm"], u["g_h"])
        cot = [torch.from_numpy(c) for c in cot]
        if mesh is not None:
            cot = [sh.shard_like(c, mesh, ()) for c in cot]
        loss = (o * cot[0]).sum() + (s_new * cot[1]).sum()
        if mesh is not None:
            loss = loss.redistribute(mesh, sh.placements_of(mesh, ()))
        grads = torch.autograd.grad(loss, leaves)
        out[f"{tag}/out"] = sh.full(o).detach().numpy()
        out[f"{tag}/state"] = sh.full(s_new).detach().numpy()
        names = ["x", "state"] + ["/".join(p) for p, _ in
                                  convert.leaves_with_paths(tree[key])]
        for name, g in zip(names, grads):
            out[f"{tag}/grad/{name}"] = sh.full(g).detach().numpy()
    return out


def _units_on_half_meshes(u: dict) -> dict:
    """`run_units` on a (data=2, model=2) mesh: each half of the 8 ranks
    is one such mesh (the ``rep`` dim of a (2, 2, 2) mesh), and on one
    device; and the TypeError `ops.rwkv6` raises for a DTensor."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels import ops
    full = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("rep", "data", "model"))
    half = full["data", "model"]
    got = run_units(u, half)
    out = {f"unit/mesh/{k}": v for k, v in got.items()}
    out.update({f"unit/one/{k}": v for k, v in run_units(u).items()})
    r = sh.shard_like(torch.zeros(2, 3, 1, 4), half, ("data", None, None,
                                                        None))
    try:
        ops.rwkv6(r, r, r, r, torch.zeros(4))
        out["unit/dtensor_error"] = np.array("")
    except TypeError as e:
        out["unit/dtensor_error"] = np.array(str(e))
    return out


def _rank_main(rank: int, world: int, port: int, out_dir: str,
               group: str = "dense") -> None:
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
            for arch in GROUPS[group]:
                out.update(run_steps(arch, data["params"][arch],
                                     data["inputs"], mesh))
        if group == "dense":
            out["ep_calls"] = np.array(spy.call_count)
            out.update(moe_ep_case(data["moe"], mesh))
        else:
            out.update(_units_on_half_meshes(data["units"]))
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


def spawn_ranks(out_dir: str, world: int = WORLD, group: str = "dense",
                meanwhile=None) -> dict:
    """Spawn `world` gloo ranks running `_rank_main` on `group`'s models
    and run `meanwhile()` (if given) in this process while they run
    (fails the calling test if they take more than SPAWN_TIMEOUT_S);
    rank 0's results."""
    ctx = mp.start_processes(_rank_main,
                             args=(world, _free_port(), out_dir, group),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    if meanwhile is not None:
        meanwhile()
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
        for arch in SERVE + FAMILY_SERVE:
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
