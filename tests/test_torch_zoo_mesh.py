"""The zoo's mesh mode on the CPU: the port's train, prefill and decode
steps on 8 gloo ranks over a (data=2, model=4) zoo mesh (the mesh of
the reference's tests/test_moe_ep.py) against the reference's sharded
steps at 8 forced XLA devices and against the port's own one-device
steps, and the expert-parallel MoE against the dense oracle.

Three kinds of run, started together and joined once a module:
* One spawn of 8 gloo ranks (`torch_zoo_mesh_ranks`): the reference's
  weights through the converter, sharded by the port's rules, every
  step on DTensors; rank 0 writes the gathered results. (The same cases
  on a (pod=2, data=2, model=2) mesh run by hand, `python
  tests/torch_zoo_mesh_ranks.py`: DTensor's first calls on three mesh
  axes take minutes.)
* One subprocess running the reference at 8 forced XLA devices on an
  ``AxisType.Auto`` mesh of the same shape (`make_host_mesh`'s Explicit
  axes trip its sharding assert under jax 0.9; ROADMAP "Reference
  health"): its jitted steps under `compat.set_mesh`, and its
  `moe_block_ep`.
* In process: the port's steps on one device, from the same weights,
  and on a (data=1, model=1) mesh over a one-rank gloo group, which
  must be bitwise the one-device steps (as chip_smoke.py's [zoo_mesh]
  holds them on the card).

Cases, at the reduced configs in float32 (olmoe at capacity factor 16,
`torch_zoo_mesh_ranks.CAPACITY_FACTOR`, so no assignment drops in
either MoE path): tinyllama's ``lm`` and ``dt`` steps and olmoe's
``lm`` step (the loss, every updated parameter and momentum leaf,
gathered), each package taking the expert-parallel path for olmoe; a
prefill of 30 tokens and 2 decode steps of both and of tinyllama with 4
kv heads (the logits: caches sharded on W, and on the heads); the
port's `moe_block_ep` against `moe_block_dense_ref`.

Bounds: the port against the reference 2e-5 absolute (the bound of
tests/test_torch_moe.py and tests/test_torch_dense_train.py), the 8
ranks against the port's one device 2e-5, `moe_block_ep` against the
dense oracle 5e-5 (the reference's tests/test_moe_ep.py bound) with its
aux within 2e-5 of the reference's. About a minute in one process.

    PYTHONPATH=src python -m pytest tests/test_torch_zoo_mesh.py
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
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.launch import mesh as tmesh
from repro_torch.models import layers as TL
from test_torch_round import torch_threads  # noqa: F401 (autouse)
from test_torch_train import _ref_drops
from torch_zoo_mesh_ranks import (B, CAPACITY_FACTOR, CASES, INPUTS, MESH,
                                  MODELS, N_DECODE, PROMPT, S, SERVE, WORLD,
                                  make_inputs, port_config, run_steps,
                                  spawn_ranks)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-5
EP_TOL = 5e-5
AUX_TOL = 2e-5
REF_TIMEOUT_S = 300

# The reference at 8 forced XLA devices: every case of the ranks, jitted
# on a (data=2, model=4) Auto mesh (with each arch's context input of
# data['aux'], if any), and moe_block_ep on the MoE case's inputs (if
# data has them); writes {key: array} and how often moe_block_ep was
# traced.
_REFERENCE8 = """
import dataclasses, pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType, Mesh
from repro import compat
from repro.configs.base import InputShape, get_config
from repro.launch import sharding as sh, steps as st
from repro.models import layers as L
assert jax.device_count() == 8, jax.device_count()
data = pickle.load(open(sys.argv[1], 'rb'))
B, S, PROMPT, N_DECODE, CF = data['sizes']
mesh = Mesh(np.array(jax.devices()).reshape(data['mesh']), ('data', 'model'),
            axis_types=(AxisType.Auto,) * 2)
calls = []
ep = L.moe_block_ep
def spy(*a, **k):
    calls.append(1)
    return ep(*a, **k)
L.moe_block_ep = spy
inp = data['inputs']
out = {}
def aux_of(arch):   # the audio family's frames, the vlm family's patches
    return {k: jnp.asarray(v) for k, v in data.get('aux', {}).get(
        arch, {}).items()}
def flat(prefix, tree):
    for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + '/' + sh._path_str(p)] = np.asarray(x)
with compat.set_mesh(mesh):
    for arch, (name, over) in data['models'].items():
        cases = data['cases'].get(arch, [])
        cfg = dataclasses.replace(get_config(name).reduced(), **over)
        p = jax.tree.map(jnp.asarray, data['params'][arch])
        p = jax.device_put(p, sh.params_shardings(mesh, p))
        for objective in cases:
            fn, _ = st.make_train_step(cfg, InputShape('t', S, B, 'train'),
                                       mesh, objective=objective, n_micro=1)
            np_, nm_, met = jax.jit(fn)(p, st.init_momentum(p), {
                'tokens': jnp.asarray(inp['tokens']),
                'blur': jnp.asarray(inp['blur']), **aux_of(arch)})
            key = arch + '/' + objective
            out[key + '/loss'] = np.asarray(met['loss'])
            flat(key + '/params', np_)
            flat(key + '/momentum', nm_)
        total = PROMPT + N_DECODE
        pf = st.make_prefill_step(cfg, InputShape('p', total, B, 'prefill'),
                                  mesh, param_dtype=jnp.float32)
        last, cache = jax.jit(pf)(p, {'tokens': jnp.asarray(inp['prompts']),
                                      **aux_of(arch)})
        logits = [np.asarray(last)]
        dec = jax.jit(st.make_decode_step(
            cfg, InputShape('d', total, B, 'decode'), mesh))
        for i in range(N_DECODE):
            lg, cache = dec(p, {'tokens': jnp.asarray(inp['decode'][i]),
                                'positions': jnp.full((B,), PROMPT + i,
                                                      jnp.int32),
                                'cache': cache})
            logits.append(np.asarray(lg))
        out[arch + '/serve_logits'] = np.stack(logits)
    out['ep_calls'] = np.array(len(calls))
    m = data.get('moe')
    if m is not None:
        cfg = dataclasses.replace(get_config('olmoe-1b-7b').reduced(),
                                  moe_capacity_factor=CF)
        y, aux = jax.jit(lambda p, x: L.moe_block_ep(cfg, p, x))(
            jax.tree.map(jnp.asarray, m['params']), jnp.asarray(m['x']))
        out['moe/y'], out['moe/aux'] = np.asarray(y), np.asarray(aux)
np.savez(sys.argv[2], **out)
"""


def _reference_inputs() -> dict:
    """The reference's float32 weights (PRNGKey(5)) of each config, the
    batches (`make_inputs`) with the reference's replayed DT drop masks,
    and test_moe_ep.py's MoE inputs (PRNGKey(0) weights, x of (4, 8, d)
    times 0.5)."""
    params = {a: jax.tree.map(np.asarray, JT.init_params(
        dataclasses.replace(j_get_config(arch).reduced(), **over),
        jax.random.PRNGKey(5))) for a, (arch, over) in MODELS.items()}
    inputs = make_inputs()
    inputs["drops"] = _ref_drops(B, S, 1).numpy()
    cfg = dataclasses.replace(j_get_config("olmoe-1b-7b").reduced(),
                              moe_capacity_factor=CAPACITY_FACTOR)
    key = jax.random.PRNGKey(0)
    moe = {"params": jax.tree.map(np.asarray, JL.init_moe(cfg, key)),
           "x": np.asarray(jax.random.normal(jax.random.fold_in(key, 1),
                                             (4, 8, cfg.d_model)) * 0.5)}
    cases = {}
    for arch, objective in CASES:
        cases.setdefault(arch, []).append(objective)
    return {"params": params, "inputs": inputs, "moe": moe, "cases": cases,
            "models": MODELS, "mesh": MESH,
            "sizes": (B, S, PROMPT, N_DECODE, CAPACITY_FACTOR)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory) -> dict:
    """The ranks', the reference's and the port's one-device results: the
    reference's subprocess and the ranks run side by side."""
    tmp = tmp_path_factory.mktemp("zoo_mesh")
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
    try:
        ranks = spawn_ranks(str(tmp))
        one, rank1 = {}, {}
        for arch in SERVE:
            one.update(run_steps(arch, data["params"][arch],
                                 data["inputs"]))
        try:                    # a one-rank group, made by zoo_mesh
            mesh = tmesh.zoo_mesh(1, 1, device="cpu")
            for arch in SERVE:
                rank1.update(run_steps(arch, data["params"][arch],
                                       data["inputs"], mesh))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            tmesh.reset_meshes()
        _, err = ref.communicate(timeout=REF_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-3000:]
    return {"ranks": ranks, "one": one, "rank1": rank1, "data": data,
            "ref": dict(np.load(tmp / "ref.npz"))}


def _keys(runs, prefix) -> list:
    keys = [k for k in runs["one"] if k.startswith(prefix)]
    assert keys
    return keys


def _max_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("arch,objective", CASES,
                         ids=[f"{a}-{o}" for a, o in CASES])
def test_train_step_on_eight_ranks(runs, arch, objective):
    """The loss and every updated parameter and momentum leaf of the
    port's 8-rank step, gathered, against the reference's sharded step
    and the port's one-device step."""
    prefix = f"{arch}/{objective}/"
    for key in _keys(runs, prefix):
        got = runs["ranks"][key]
        assert got.shape == runs["one"][key].shape, key
        assert _max_err(got, runs["ref"][key]) <= TOL, key
        assert _max_err(got, runs["one"][key]) <= TOL, key


@pytest.mark.parametrize("arch", SERVE)
def test_prefill_and_decode_on_eight_ranks(runs, arch):
    """The prefill's last logits and 2 decode steps' logits through the
    sharded caches (the reduced configs' 2 kv heads do not divide over
    model = 4, so the ring's W axis is sharded; tinyllama-kv4's 4 kv
    heads are)."""
    key = f"{arch}/serve_logits"
    got = runs["ranks"][key]
    assert got.shape == (N_DECODE + 1, B, port_config(arch).padded_vocab)
    assert np.isfinite(got).all()
    assert _max_err(got, runs["ref"][key]) <= TOL
    assert _max_err(got, runs["one"][key]) <= TOL


def test_one_rank_mesh_is_bitwise_the_one_device_steps(runs):
    """At world size 1 (a (data=1, model=1) mesh over a one-rank gloo
    group) every result of every case is bitwise the one-device step's,
    as chip_smoke.py's [zoo_mesh] holds it on the card."""
    assert set(runs["rank1"]) == set(runs["one"])
    for key, want in runs["one"].items():
        np.testing.assert_array_equal(runs["rank1"][key], want, err_msg=key)


def test_host_and_production_meshes():
    """`make_host_mesh` is the (data=1, model=1) zoo mesh at world size 1
    (a one-rank gloo group made for it); `make_production_mesh` needs
    256 or 512 ranks and says so."""
    try:
        mesh = tmesh.make_host_mesh(device="cpu")
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == tmesh.ZOO_AXES
        assert tmesh.zoo_mesh(1, 1, device="cpu") is mesh
        for multi, need in ((False, 256), (True, 512)):
            with pytest.raises(ValueError, match=f"needs {need} ranks"):
                tmesh.make_production_mesh(multi_pod=multi, device="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        tmesh.reset_meshes()


def test_both_packages_take_the_expert_parallel_path(runs):
    """olmoe's MoE layers run `moe_block_ep` in both packages: at (8, 32)
    tokens each data shard sends more than a token an expert, so the
    "auto" rule picks it, and so it does for the prefill and decode."""
    assert port_config("olmoe-1b-7b").moe_impl == "auto"
    assert int(runs["ranks"]["ep_calls"]) > 0
    assert int(runs["ref"]["ep_calls"]) > 0


def test_moe_block_ep_matches_dense_oracle(runs):
    """The port's `moe_block_ep` on the 8 ranks against the port's dense
    oracle (every token through every expert) at capacity factor 16, and
    its aux against the reference's `moe_block_ep` on its 8 devices."""
    got = runs["ranks"]
    m = runs["data"]["moe"]
    cfg = port_config("olmoe-1b-7b")
    p = convert.zoo_params_from_numpy(m["params"], "cpu")
    want = TL.moe_block_dense_ref(cfg, p, torch.from_numpy(m["x"].copy()))
    assert _max_err(got["moe/y"], want.numpy()) <= EP_TOL
    assert _max_err(got["moe/y"], runs["ref"]["moe/y"]) <= EP_TOL
    assert abs(float(got["moe/aux"]) - float(runs["ref"]["moe/aux"])) \
        <= AUX_TOL
    assert float(got["moe/aux"]) >= 0.0


def test_ranks_ran_on_the_mesh(runs):
    """The ranks' world and mesh: 8 ranks on (data=2, model=4)."""
    assert int(runs["ranks"]["world"]) == WORLD
    assert tuple(runs["ranks"]["mesh"]) == MESH
