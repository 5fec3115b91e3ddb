"""The zoo's mesh mode for the rwkv6, hybrid, audio and vlm families on
the CPU: the port's train, prefill and decode steps on 8 gloo ranks over
a (data=2, model=4) zoo mesh against the reference's sharded steps at 8
forced XLA devices and against the port's own one-device steps; the
local-shard rwkv6 time-mix and selective scan on (data=2, model=2)
meshes; the (1, 1) mesh bitwise; the drivers' mesh mode.

Three kinds of run, started together and joined once a module, as
tests/test_torch_zoo_mesh.py's:
* One spawn of 8 gloo ranks (`torch_zoo_mesh_ranks`, its ``families``
  group): the reference's weights through the converter, sharded by the
  port's rules, every step on DTensors; then each half of the ranks a
  (data=2, model=2) mesh running `rwkv_tmix_chunked` and `ssm_block`
  with carried states (the rwkv6 kernel's and the scan's local-shard
  paths) and the DTensor guard of `ops.rwkv6`; rank 0 writes the
  gathered results.
* One subprocess running the reference at 8 forced XLA devices on an
  ``AxisType.Auto`` mesh of the same shape (test_torch_zoo_mesh's
  `_REFERENCE8`, with the frames and patches), each step compiled once.
* In process, while the ranks run: the port's steps on one device, from
  the same weights, and on a (data=1, model=1) mesh over a one-rank gloo
  group, which must be bitwise the one-device steps (as chip_smoke.py's
  [zoo_mesh] holds them on the card).

Cases, at the reduced configs in float32: rwkv6's ``lm`` and ``dt``
steps and hymba's, seamless's (with frames) and llama-3.2-vision's (with
patches) ``lm`` steps (the loss, every updated parameter and momentum
leaf, gathered); a prefill of 30 tokens and 2 decode steps of all four
(the logits). The cross blocks' gates are drawn from a seed, the same in
both packages (test_torch_audio's `_gated`): at the reference's zero
init a missing encoder or cross attention would pass. Beside them:
micro-batches of one sequence on a (1, 1) mesh, bitwise; the drivers'
``--model-parallel 1`` for every family.

Bounds: the port against the reference 2e-5 absolute and the 8 ranks
against the port's one device 2e-5 (tests/test_torch_zoo_mesh.py's);
the local-shard cases' outputs and states 2e-5 absolute, their
gradients (sums over every token, up to 54 in size) 2e-5 of each leaf's
largest magnitude (at least 1). About 75 s in one process.

    PYTHONPATH=src python -m pytest tests/test_torch_zoo_mesh_families.py
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.base import get_config as j_get_config
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs.base import InputShape
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as sh
from repro_torch.launch import steps as tst
from repro_torch.models import transformer as TT
from test_torch_audio import _gated
from test_torch_round import torch_threads  # noqa: F401 (autouse)
from test_torch_train import _ref_drops
from test_torch_zoo_mesh import _REFERENCE8, _max_err
from torch_zoo_mesh_ranks import (B, FAMILY_CASES, FAMILY_MODELS,
                                  FAMILY_SERVE, INPUTS, MESH, N_DECODE,
                                  PROMPT, S, WORLD, aux_inputs, make_inputs,
                                  port_config, run_steps, spawn_ranks,
                                  train_batch, unit_inputs)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-5
REF_TIMEOUT_S = 300
GATE_SEED = 11


def _reference_inputs() -> dict:
    """The reference's float32 weights (PRNGKey(5)) of each config with
    their gates drawn (GATE_SEED), the batches (`make_inputs`) with the
    reference's replayed DT drop masks and each arch's context input,
    and the local-shard cases' inputs."""
    params = {a: _gated(jax.tree.map(np.asarray, JT.init_params(
        dataclasses.replace(j_get_config(arch).reduced(), **over),
        jax.random.PRNGKey(5))), GATE_SEED)
        for a, (arch, over) in FAMILY_MODELS.items()}
    inputs = make_inputs()
    inputs["drops"] = _ref_drops(B, S, 1).numpy()
    aux = {"seamless-m4t-large-v2": {"frames": inputs["frames"]},
           "llama-3.2-vision-90b": {"patches": inputs["patches"]}}
    cases = {}
    for arch, objective in FAMILY_CASES:
        cases.setdefault(arch, []).append(objective)
    return {"params": params, "inputs": inputs, "aux": aux, "cases": cases,
            "models": FAMILY_MODELS, "mesh": MESH, "units": unit_inputs(),
            "sizes": (B, S, PROMPT, N_DECODE, 0.0)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory) -> dict:
    """The ranks', the reference's and the port's one-device and one-rank
    mesh results: the reference's subprocess and the ranks run side by
    side."""
    tmp = tmp_path_factory.mktemp("zoo_mesh_families")
    data = _reference_inputs()
    with open(tmp / INPUTS, "wb") as f:
        pickle.dump(data, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                           os.path.join(ROOT, "tests")]))
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE8,
                            str(tmp / INPUTS), str(tmp / "ref.npz")],
                           env=env, cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    one, rank1 = {}, {}

    def in_process():          # one thread: the ranks hold the cores
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        for arch in FAMILY_SERVE:
            one.update(run_steps(arch, data["params"][arch],
                                 data["inputs"]))
        try:                    # a one-rank group, made by zoo_mesh
            mesh = tmesh.zoo_mesh(1, 1, device="cpu")
            for arch in FAMILY_SERVE:
                rank1.update(run_steps(arch, data["params"][arch],
                                       data["inputs"], mesh))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            tmesh.reset_meshes()
            torch.set_num_threads(threads)

    try:
        ranks = spawn_ranks(str(tmp), group="families", meanwhile=in_process)
        _, err = ref.communicate(timeout=REF_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-3000:]
    return {"ranks": ranks, "one": one, "rank1": rank1,
            "ref": dict(np.load(tmp / "ref.npz"))}


def _keys(runs, prefix) -> list:
    keys = [k for k in runs["one"] if k.startswith(prefix)]
    assert keys
    return keys


@pytest.mark.parametrize("arch,objective", FAMILY_CASES,
                         ids=[f"{a}-{o}" for a, o in FAMILY_CASES])
def test_train_step_on_eight_ranks(runs, arch, objective):
    """The loss and every updated parameter and momentum leaf of the
    port's 8-rank step, gathered, against the reference's sharded step
    and the port's one-device step: rwkv6's kernel path on (batch, head)
    shards, hymba's scan on (batch, di) shards, seamless's encoder and
    vlm's projector with the cross blocks over a batch-sharded
    context."""
    prefix = f"{arch}/{objective}/"
    for key in _keys(runs, prefix):
        got = runs["ranks"][key]
        assert got.shape == runs["one"][key].shape, key
        assert _max_err(got, runs["ref"][key]) <= TOL, key
        assert _max_err(got, runs["one"][key]) <= TOL, key


@pytest.mark.parametrize("arch", FAMILY_SERVE)
def test_prefill_and_decode_on_eight_ranks(runs, arch):
    """The prefill's last logits and 2 decode steps' logits through the
    sharded caches: rwkv6's states on (batch, head), hymba's rings on W
    beside its SSM and conv states on di, the audio and vlm contexts on
    the batch."""
    key = f"{arch}/serve_logits"
    got = runs["ranks"][key]
    assert got.shape == (N_DECODE + 1, B, port_config(arch).padded_vocab)
    assert np.isfinite(got).all()
    assert _max_err(got, runs["ref"][key]) <= TOL
    assert _max_err(got, runs["one"][key]) <= TOL


@pytest.mark.parametrize("arch", FAMILY_SERVE)
def test_one_rank_mesh_is_bitwise_the_one_device_steps(runs, arch):
    """At world size 1 (a (data=1, model=1) mesh over a one-rank gloo
    group) the mesh train, prefill and decode steps of every family
    build, run and give every result bitwise the one-device step's, as
    chip_smoke.py's [zoo_mesh] holds them on the card."""
    keys = _keys(runs, f"{arch}/")
    assert {k for k in runs["rank1"] if k.startswith(f"{arch}/")} == \
        set(keys)
    assert f"{arch}/serve_logits" in keys
    for key in keys:
        np.testing.assert_array_equal(runs["rank1"][key], runs["one"][key],
                                      err_msg=key)


@pytest.mark.parametrize("tag", ["rwkv", "ssm"])
def test_local_shard_ops_on_a_two_by_two_mesh(runs, tag):
    """`rwkv_tmix_chunked` (the rwkv6 kernel's path on each rank's
    (batch, head) shards) and `ssm_block` (the scan on (batch, di)
    shards, B and C reduced over ``model``) on DTensors of a (data=2,
    model=2) mesh, with a carried state, against the one-device
    functions: the outputs, the new states (and the conv state), and
    the gradients of the weights, x and the state."""
    ranks = runs["ranks"]
    keys = [k for k in ranks if k.startswith(f"unit/one/{tag}/")]
    assert any("/grad/u" in k or "/grad/A_log" in k for k in keys)
    for key in keys:
        got, want = ranks[key.replace("/one/", "/mesh/")], ranks[key]
        assert got.shape == want.shape, key
        scale = max(1.0, float(np.abs(want).max())) if "/grad/" in key \
            else 1.0
        assert _max_err(got, want) <= TOL * scale, key


def test_rwkv6_refuses_dtensors(runs):
    """`ops.rwkv6` given a DTensor raises TypeError naming the
    local-shard entry point, before the plain version or a launch reads
    a DTensor's storage."""
    msg = str(runs["ranks"]["unit/dtensor_error"])
    assert "rwkv6_on_shards" in msg, msg


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "llama-3.2-vision-90b"])
def test_one_sequence_micro_batches_on_a_one_rank_mesh(arch):
    """Micro-batches of one sequence, and a prefill and decode step of
    one prompt, on a (data=1, model=1) mesh, for a decoder-only model
    and one with a context input: the batch dim of size 1 stays
    replicated (`sharding.placements_of` given the shape), where a
    Shard(0) of it left DTensor no strategy for the products that fold
    it (and on the card, torch 2.11, a vision_proj gradient 1.9e-9 off
    the one-card step's); every result bitwise the one-device steps'."""
    cfg = port_config(arch)
    drawn = TT.init_params(cfg, torch.Generator().manual_seed(5))
    params = convert.zoo_params_from_numpy(
        _gated(convert.zoo_params_to_numpy(drawn), GATE_SEED), "cpu")
    inputs = make_inputs()
    batch = {k: v[:2] for k, v in train_batch(arch, inputs, "lm").items()}
    shape = InputShape("t", S, 2, "train")
    serve = {"tokens": torch.from_numpy(inputs["prompts"][:1].astype(
        np.int64)), **{k: v[:1] for k, v in aux_inputs(arch, inputs).items()}}
    step = torch.from_numpy(inputs["decode"][0, :1].astype(np.int64))

    def run(mesh):
        p = params if mesh is None else tst.shard_params(cfg, params, mesh)
        fn, _ = tst.make_train_step(cfg, shape, mesh, n_micro=2)
        new_p, new_m, met = fn(p, tst.init_momentum(p), batch)
        total = InputShape("s", PROMPT + 1, 1, "prefill")
        last, cache = tst.make_prefill_step(cfg, total, torch.float32,
                                            mesh=mesh)(p, dict(serve))
        lg, _ = tst.make_decode_step(cfg, total, mesh=mesh)(p, {
            "tokens": step, "positions": torch.full((1,), PROMPT),
            "cache": cache})
        return {"loss": met["loss"], "params": new_p, "momentum": new_m,
                "prefill": last, "decode": lg}

    want = run(None)
    try:
        got = sh.gather_tree(run(tmesh.zoo_mesh(1, 1, device="cpu")))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        tmesh.reset_meshes()
    for (path, a), (_, b) in zip(convert.leaves_with_paths(got),
                                 convert.leaves_with_paths(want)):
        np.testing.assert_array_equal(a.detach().numpy(),
                                      b.detach().numpy(),
                                      err_msg="/".join(path))


@pytest.mark.parametrize("arch", FAMILY_SERVE)
def test_mesh_launchers_run_every_family(arch, capsys):
    """The drivers' mesh mode (``--model-parallel 1`` at world size 1, a
    (data=1, model=1) mesh over a one-rank gloo group) trains and serves
    each family at ``--reduced``, at the sizes of the fixture's steps
    (whose sharding propagation DTensor has cached by then)."""
    from repro_torch.launch import decode as tdecode
    from repro_torch.launch import train as ttrain
    common = ["--arch", arch, "--reduced", "--device", "cpu",
              "--model-parallel", "1", "--batch", str(B)]
    try:
        ttrain.main(common + ["--steps", "1", "--seq-len", str(S)])
        tdecode.main(common + ["--prompt-len", str(PROMPT), "--tokens",
                               str(N_DECODE)])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        tmesh.reset_meshes()
    out = capsys.readouterr().out
    assert "step 0: loss=" in out and "mesh" in out, out
    assert "decode steps" in out, out


def test_mesh_steps_take_every_family():
    """`make_train_step`, `make_prefill_step` and `make_decode_step` with
    a mesh build for every zoo family (the rules read only the mesh's
    axis names and sizes, so a `ShapeMesh` serves)."""
    mesh = tmesh.ShapeMesh((1, 1), ("data", "model"))
    shape = InputShape("t", 16, 2, "train")
    assert set(tst.MESH_FAMILIES) == {"dense", "moe", "ssm", "hybrid",
                                      "audio", "vlm"}
    for arch in FAMILY_SERVE:
        cfg = port_config(arch)
        assert callable(tst.make_train_step(cfg, shape, mesh)[0])
        assert callable(tst.make_prefill_step(cfg, shape, mesh=mesh))
        assert callable(tst.make_decode_step(cfg, shape, mesh=mesh))


def test_ranks_ran_on_the_mesh(runs):
    """The ranks' world and mesh: 8 ranks on (data=2, model=4)."""
    assert int(runs["ranks"]["world"]) == WORLD
    assert tuple(runs["ranks"]["mesh"]) == MESH
