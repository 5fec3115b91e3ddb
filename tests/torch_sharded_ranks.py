"""The rank program of tests/test_torch_sharded.py, and the inputs it
shares with the parent: each gloo rank imports this module alone (torch,
numpy and the port, no JAX), runs every multi-rank case and writes its
results to an npz for the parent to compare.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
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
from repro_torch.core import aggregation as tagg
from repro_torch.core import collectives as coll
from repro_torch.core import hierarchical as thier
from repro_torch.core.cohort import CohortBatch
from repro_torch.core.scenario import Scenario, run, run_campaign
from repro_torch.core.state import FLConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.models import resnet

SPAWN_TIMEOUT_S = 240
WORLDS = (2, 4)
# the reference's round-0 state and its plan, saved by the parent for the
# ranks (tests/test_torch_sharded.py, `_save_reference_start`)
REF_START = "reference_start.pt"

# a cohort row: the tree {"a": (4, 3), "b": {"c": (7,)}}, P = 19
TREE = {"a": (4, 3), "b": {"c": (7,)}}
SPEC = convert.flat_spec(convert.tree_map(torch.zeros, TREE))
DISCARD_BLUR = (11.6, 17.4, 12.8, 19.0, 14.2)   # straddles blur_threshold

_RS = np.random.RandomState(1)
DATA = [_RS.rand(20, 16, 16, 3).astype(np.float32) for _ in range(8)]
PARITY = dict(data=DATA, n_vehicles=8, vehicles_per_round=4, batch_size=8,
              rounds=4, local_iters=1, lr=0.4, seed=11)
# tests/test_torch_engine.py's ENGINE_TINY images, for what is bitwise
_RS = np.random.RandomState(0)
TINY = dict(PARITY, data=[_RS.rand(6, 4, 4, 3).astype(np.float32)
                          for _ in range(8)], batch_size=2)
MULTI = {"n_rsus": 2}
HANDOVER = {"n_rsus": 2, "rsu_range": 200.0, "round_duration": 50.0,
            "sync_every": 2}


# --------------------------------------------------------------------------
# inputs, made with numpy from a seed (the same in the parent and ranks)
# --------------------------------------------------------------------------

def _rows(seed: int, m: int) -> np.ndarray:
    return np.random.RandomState(seed).randn(m, SPEC.size).astype(np.float32)


def _blur(seed: int, n: int) -> np.ndarray:
    return np.random.RandomState(seed + 100).uniform(10, 20, n) \
        .astype(np.float32)


def _cohort(seed: int, n: int, m: int, blur=None) -> CohortBatch:
    """n valid rows padded to m (the padding rows zero, masked out)."""
    c = CohortBatch.empty(SPEC, m, n=n)
    c.flat[:] = torch.from_numpy(_rows(seed, m))
    c.flat[n:].zero_()
    blur = _blur(seed, n) if blur is None else np.asarray(blur, np.float32)
    return c.with_stats(blur=torch.from_numpy(blur))


def _hier_cohort(seed: int = 10, R: int = 2, s: int = 4) -> CohortBatch:
    return _cohort(seed, R * s, R * s)


def _cancel_cohort() -> CohortBatch:
    """The reference's float64-accumulation case: (+3e4, -3e4) pairs that
    cancel, blur levels whose weights are dyadic (every weight sum exact
    in float32 in any order), 8 rows of 24 values."""
    rs = np.random.RandomState(0)
    big = np.tile([3e4, -3e4], 4)[:, None]
    x = (rs.randn(8, 24) + big).astype(np.float32)
    spec = convert.flat_spec({"w": torch.zeros(24)})
    c = CohortBatch.empty(spec, 8)
    c.flat[:] = torch.from_numpy(x)
    return c.with_stats(blur=torch.tensor([8, 8, 16, 16, 16, 16, 24, 24.0]))


def _cancel_expect() -> np.ndarray:
    c = _cancel_cohort()
    L = c.blur.numpy()
    w1 = (L.sum() - L) / L.sum()
    w1 = (w1 / w1.sum()).astype(np.float32)
    return np.tensordot(w1.astype(np.float64), c.flat.numpy()
                        .astype(np.float64), axes=1).astype(np.float32)


def _row(tree) -> np.ndarray:
    return convert.ravel(tree).numpy()


@functools.lru_cache(maxsize=None)
def _narrow_tree() -> dict:
    """The rounds' model: ResNet-18-CIFAR at an eighth of its widths (8,
    16, 32, 64; the 128-D projector kept), random from seed 11. At full
    width a client step costs about a second on one CPU thread whatever
    the image size, most of it in the 11.5M-parameter updates."""
    with mock.patch.object(resnet, "WIDTHS", (8, 16, 32, 64)):
        return resnet.init_resnet(get_config("resnet18-cifar"),
                                  torch.Generator().manual_seed(11), "cpu")


def _scenario(topology="multi", tkw=None, size=PARITY, **over) -> Scenario:
    tkw = dict(MULTI if topology == "multi" else HANDOVER, **(tkw or {}))
    return Scenario(topology=topology, topology_kwargs=tkw, device="cpu",
                    global_tree=_narrow_tree(), **{**size, **over})


def _sans_loss(rec) -> dict:
    return {k: v for k, v in rec.items() if k != "loss"}


def _handover_sched(hist) -> np.ndarray:
    return np.array([[r["n_handovers"], int(r["synced"])] + r["rsu_sizes"]
                     for r in hist])


def _state_rows(state) -> dict:
    """Every tensor of an FLState (and the host state), as numpy."""
    out = {"global": _row(state.global_tree),
           "gen_state": state.gen_state.numpy(),
           "host_rng": np.append(state.host_rng["mt_keys"],
                                 state.host_rng["mt_pos"])}
    if state.comms is not None:
        out["ef"] = state.comms["ef"].numpy()
    for r, m in enumerate(state.topo.get("rsu_models", ())):
        out[f"rsu{r}"] = _row(m)
    for k in ("positions", "blur_sum", "upload_count"):
        if k in state.topo:
            out[k] = np.asarray(state.topo[k])
    return out


def _losses(hist) -> np.ndarray:
    return np.array([r["loss"] for r in hist])


@contextlib.contextmanager
def recording_scales():
    """Within the block, each delta_int8 encode appends its largest block
    scale (one int8 code step) to the list it yields."""
    from repro_torch.comms import codecs
    codec, steps = codecs.CODECS["delta_int8"], []

    def encode(rows, base, ef=None):
        payload, new_ef = codec.encode(rows, base, ef)
        steps.append(float(payload["scales"].max()))
        return payload, new_ef

    codecs.CODECS["delta_int8"] = dataclasses.replace(codec, encode=encode)
    try:
        yield steps
    finally:
        codecs.CODECS["delta_int8"] = codec


def int8_rounds(sc) -> dict:
    """Two delta_int8 rounds of `sc` from its round-0 state, one `run`
    call each: the global rows and error feedback after each, the losses
    and the code steps."""
    with recording_scales() as steps:
        st_1, hist_1 = run(sc, rounds=1)
        st_2, hist_2 = run(sc, st_1, rounds=1)
    return {"global1": _row(st_1.global_tree),
            "ef1": st_1.comms["ef"].numpy(),
            "global2": _row(st_2.global_tree),
            "ef2": st_2.comms["ef"].numpy(),
            "loss": _losses(hist_1 + hist_2), "steps": np.array(steps),
            "states": (st_1, st_2), "hist": hist_1 + hist_2}


# --------------------------------------------------------------------------
# the rank program
# --------------------------------------------------------------------------

def _aggregation_cases(world: int, out: dict) -> None:
    mesh = tmesh.cohort_mesh(2, world // 2, "cpu")
    c = _cohort(0, 5, 8, blur=DISCARD_BLUR)
    for name in sorted(tagg.AGGREGATORS):
        cfg = FLConfig(aggregator=name)
        for red in ("gather", "split"):
            out[f"agg/{name}/{red}"] = _row(thier.sharded_aggregate(
                c, cfg, mesh, reduction=red))
    small = _cohort(2, 2, 3)
    for red in ("gather", "split"):
        out[f"small/{red}"] = _row(thier.sharded_aggregate(
            small, FLConfig(), mesh, reduction=red))
    out["invalid_shard"] = _row(thier.sharded_aggregate(
        _cohort(3, 2, 8), FLConfig(aggregator="fedavg"), mesh))
    w = torch.tensor([0.4, 0.3, 0.2, 0.1])
    c4 = _cohort(4, 4, 8)
    out["explicit"] = _row(thier.sharded_cohort_sum(c4, w, mesh))
    sh = c4.shard(mesh)
    out["rank/shard_rows"] = np.array([sh.row0, sh.flat.shape[0], sh.size])
    out["shard_gather"] = sh.gather().flat.numpy()
    out["sharded_input"] = _row(thier.sharded_cohort_sum(sh, w, mesh))
    h = _hier_cohort()
    for cs in (True, False):
        out[f"exact/{cs}"] = _row(thier.sharded_hierarchical(
            h, mesh, 2, count_scaled=cs))
    out["psum"] = _row(thier.sharded_hierarchical(h, mesh, 2,
                                                  reduction="psum"))
    cancel = _cancel_cohort()
    line = tmesh.cohort_mesh(1, world, "cpu")
    out["cancel/f32"] = thier.sharded_hierarchical_row(
        cancel, line, 1, reduction="psum").numpy()
    out["cancel/f64"] = thier.sharded_hierarchical_row(
        cancel, line, 1, reduction="psum",
        accum_dtype=torch.float64).numpy()
    # the scalar form: one row a rank (8 / world ranks' rows summed first)
    rank = coll.cohort_rank(line)
    b = 8 // world
    blk = cancel.flat[rank * b:(rank + 1) * b]
    L = cancel.blur[rank * b:(rank + 1) * b]
    data_g, pod_g = line.get_group("data"), line.get_group("pod")
    out["scalar"] = thier.two_stage_weighted_psum(
        blk[0], L[0], rsu_group=data_g, region_group=pod_g).numpy()
    out["scalar_ref"] = thier.two_stage_weighted_psum(
        blk[:1], L[:1], rsu_group=data_g, region_group=pod_g).numpy()
    out["normalized_w"] = coll.all_gather_rows(
        tagg.normalized_weight_on_axis(L[0], data_g)[None], data_g).numpy()


def _round_cases(world: int, out: dict, out_dir: str) -> None:
    from repro_torch.comms.codecs import roundtrip_cohort
    # PARITY size: the rounds held against the host rounds within the
    # round tolerances
    sc = _scenario()
    assert tmesh.axis_size(sc.topology.resolve_mesh(sc.cfg, "cpu")) == world
    st, hist = run(sc, rounds=1)
    out["par/global"], out["par/loss"] = _row(st.global_tree), _losses(hist)
    # the reference's round 0, its draws replayed, through the same mesh
    ref = torch.load(os.path.join(out_dir, REF_START), weights_only=False)
    st, rec = sc.topology.execute(ref["state"], sc, ref["plan"])
    out["ref/global"], out["ref/loss"] = (_row(st.global_tree),
                                          np.array(rec["loss"]))
    out["ref/velocities"] = np.array(rec["velocities"])
    hsc = _scenario("handover", {"mesh_shard": True})
    st, hist = run(hsc, rounds=2)
    for k, v in _state_rows(st).items():
        out[f"handover/{k}"] = v
    out["handover/loss"] = _losses(hist)
    out["handover/sched"] = _handover_sched(hist)
    # TINY size: the bitwise comparisons
    for mesh_aggregate in (None, False):
        tsc = _scenario(size=TINY, tkw={"mesh_aggregate": mesh_aggregate})
        for parallel in (False, True):
            st, hist = run(tsc, rounds=1, parallel=parallel)
            key = f"tiny/{mesh_aggregate}/{parallel}"
            out[f"{key}/global"] = _row(st.global_tree)
            out[f"{key}/loss"] = _losses(hist)
    dsc = _scenario(size=TINY, codec="delta")
    st, hist = run(dsc, rounds=1)
    out["delta/global"], out["delta/loss"] = (_row(st.global_tree),
                                              _losses(hist))
    psc = _scenario(size=TINY, tkw={"mesh_reduction": "psum"})
    out["tiny_psum/global"] = _row(run(psc, rounds=1)[0].global_tree)
    # delta_int8 over the mesh and on the host path (in the rank, at its
    # thread count), two rounds each; the campaign over the mesh
    isc = _scenario(codec="delta_int8")
    st_c, hist_c = run_campaign(isc, rounds=2, mode="eager")
    int8 = int8_rounds(isc)
    (_, st_r), hist_r = int8.pop("states"), int8.pop("hist")
    host = int8_rounds(_scenario(codec="delta_int8",
                                 tkw={"mesh_aggregate": False}))
    for k in ("states", "hist"):
        host.pop(k)
    # each rank encodes its own block: the largest step over the ranks
    steps = torch.from_numpy(int8["steps"])
    dist.all_reduce(steps, op=dist.ReduceOp.MAX)
    int8["steps"] = steps.numpy()
    for tag, rounds in (("int8", int8), ("int8host", host)):
        for k, v in rounds.items():
            out[f"{tag}/{k}"] = v
    for k, v in _state_rows(st_c).items():
        out[f"campaign/{k}"] = v
    for k, v in _state_rows(st_r).items():
        out[f"run/{k}"] = v
    out["campaign/same_schedule"] = np.array(
        [_sans_loss(r) for r in hist_c] == [_sans_loss(r) for r in hist_r])
    out["campaign/loss"], out["run/loss"] = (_losses(hist_c),
                                             _losses(hist_r))
    # the codec stage alone: a sharded cohort's block roundtrip against
    # the host roundtrip of the whole cohort, slots by cohort index
    mesh = isc.topology.resolve_mesh(isc.cfg, "cpu")
    c = _cohort(6, 4, 4)
    base = convert.unravel(torch.from_numpy(_rows(7, 1)[0]), SPEC)
    comms = {"ef": torch.from_numpy(np.random.RandomState(8).randn(4, 256)
                                    .astype(np.float32)) * 1e-3}
    perm = np.array([0, 2, 1, 3])
    shc, shcomms = roundtrip_cohort(isc.cfg, c.shard(mesh), base, comms,
                                    rows=perm)
    hc, hcomms = roundtrip_cohort(isc.cfg, c, base, comms, rows=perm)
    out["codec/sharded_rows"] = shc.gather().flat.numpy()
    out["codec/host_rows"] = hc.flat.numpy()
    out["codec/sharded_ef"] = shcomms["ef"].numpy()
    out["codec/host_ef"] = hcomms["ef"].numpy()
    _checkpoint_cases(out, out_dir)


def _flstate(state) -> dict:
    """Every leaf of an FLState's checkpoint tree (`to_tree`), as numpy,
    by its index in the checkpoint's leaf order."""
    from repro_torch.checkpoint.store import _leaves
    return {f"leaf{i}": (x.numpy() if isinstance(x, torch.Tensor)
                         else np.asarray(x))
            for i, x in enumerate(_leaves(state.to_tree()))}


def _checkpoint_cases(out: dict, out_dir: str) -> None:
    """A sharded TINY campaign of 4 rounds, straight; with
    checkpoint_every=2 into one directory all ranks share (the save_state
    and save calls on this rank counted; both checkpoints read back as
    soon as run_campaign returns); resumed from the round-2 checkpoint
    for 2 more rounds; and as two chunks of 2 rounds."""
    from repro_torch.checkpoint import store
    sc = _scenario(size=TINY)
    ck_dir = os.path.join(out_dir, "campaign_ckpt")
    runs = {"straight": run_campaign(sc, rounds=4, mode="eager")}
    with mock.patch.object(store, "save_state",
                           wraps=store.save_state) as saves, \
            mock.patch.object(store, "save", wraps=store.save) as writes:
        runs["chunked"] = run_campaign(sc, rounds=4, mode="eager",
                                       checkpoint_every=2,
                                       checkpoint_dir=ck_dir)
    out["rank/ckpt_calls"] = np.array([saves.call_count, writes.call_count])
    path, step = store.latest(ck_dir)
    out["ckpt/latest_step"] = np.array(step)
    mid = store.restore_state(os.path.join(ck_dir, "round_000002"),
                              scenario=sc)
    runs["restored_end"] = (store.restore_state(path, scenario=sc), [])
    runs["resumed"] = run_campaign(sc, mid, rounds=2, mode="eager")
    first = run_campaign(sc, rounds=2, mode="eager")
    second = run_campaign(sc, first[0], rounds=2, mode="eager")
    runs["chunks"] = (second[0], first[1] + second[1])
    runs["restored_mid"], runs["first_chunk"] = (mid, []), first
    for name, (state, hist) in runs.items():
        for k, v in _flstate(state).items():
            out[f"ckpt/{name}/{k}"] = v
        out[f"ckpt/{name}/round"] = np.array(state.round)
        if hist:
            out[f"ckpt/{name}/loss"] = _losses(hist)

    def sched(hist):
        return [_sans_loss(r) for r in hist]

    want = sched(runs["straight"][1])
    out["ckpt/same_schedule"] = np.array([
        sched(runs["chunked"][1]) == want,
        sched(runs["resumed"][1]) == want[2:],
        sched(runs["chunks"][1]) == want])


def _rank_main(rank: int, world: int, port: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=SPAWN_TIMEOUT_S))
    try:
        out = {"world": np.array(dist.get_world_size())}
        t = time.time()
        _aggregation_cases(world, out)
        _round_cases(world, out, out_dir)
        out["seconds"] = np.array(time.time() - t)
        print(f"rank {rank}/{world}: {float(out['seconds']):.1f} s",
              flush=True)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(world: int, out_dir: str) -> list:
    """Spawn `world` gloo ranks running `_rank_main` (fails the calling
    test if they take more than SPAWN_TIMEOUT_S); every rank's results."""
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
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
            for r in range(world)]


