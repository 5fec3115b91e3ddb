"""The port's dry run (launch/dryrun.py) and the last `ModelConfig` and
`MobilityModel` methods, against the reference on the CPU:

* `n_params`, `n_active_params` and `is_encdec` of every config and its
  reduced variant, and `is_blurred` on a grid around 100 km/h, exactly
  the reference's;
* `rank_bytes`: every leaf's local shard shape of the params, the
  momentum, the inputs and the cache (bf16 and int8) of every
  architecture and input shape on the production meshes equals the
  shard shape of jax's `NamedSharding` of the reference's spec on an
  `AbstractMesh` (nothing compiled), and the sums follow;
* `collective_bytes` on records of tests/test_dryrun_parser.py's
  FIXTURE_HLO shapes equals the reference's HLO parse;
* the kernels' shape-only path on fake tensors, and their plain path on
  real CPU tensors;
* fake traces on small fake worlds in a subprocess
  (tests/torch_dryrun_worker.py): every record ok, the arguments equal
  to the steps' own placement, the MoE all-to-all seen, the rwkv6
  kernel's operations counted, and the FLOPs of a (data=4, model=1)
  rank a quarter of one device's.

The collectives, FLOPs and memory are not held against the reference's
HLO: GSPMD and DTensor choose different collectives and fusions.

    PYTHONPATH=src python -m pytest tests/test_torch_dryrun.py
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.configs.base import get_config as j_get_config
from repro.core.mobility import MobilityModel as JMobility
from repro.launch import sharding as jsh
from repro.launch import steps as jst
from repro.launch.dryrun import collective_bytes as j_collective_bytes
from repro_torch.configs import get_config, list_configs
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.convert import leaves_with_paths
from repro_torch.core.mobility import KMH_100, MobilityModel
from repro_torch.kernels import dt_loss as dt_kernel
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6 as rwkv6_kernel
from repro_torch.launch import dryrun as dr
from test_dryrun_parser import FIXTURE_HLO
from test_torch_sharding import _meshes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = [a for a in list_configs() if a != "resnet18-cifar"]
WORKER = os.path.join(ROOT, "tests", "torch_dryrun_worker.py")
WORKER_TIMEOUT_S = 240
J_CACHE = {"bf16": "bfloat16", "int8": "int8"}
# the port's token ids and decode positions are int64, the reference's
# int32: the shard shapes are equal, the bytes follow each package's
# dtype
INT_INPUTS = ("tokens", "positions")


@pytest.mark.parametrize("arch", list_configs())
def test_config_methods_match_reference(arch):
    for name in (arch, arch + "-smoke"):
        t, j = get_config(name), j_get_config(name)
        assert t.n_params() == j.n_params(), name
        assert t.n_active_params() == j.n_active_params(), name
        assert t.is_encdec == j.is_encdec, name
        assert isinstance(t.n_params(), int)


def test_is_blurred_matches_reference():
    """On float32 and float64 grids around 100 km/h (KMH_100 itself and
    its neighbours), lists, scalars and ints, with the default and
    custom thresholds: the same bools, as a bool tensor."""
    k32 = np.float32(KMH_100)
    grid32 = np.array([0.0, 16.67, np.nextafter(k32, np.float32(0)), k32,
                       np.nextafter(k32, np.float32(100)), 30.0, 41.67],
                      np.float32)
    grid64 = np.array([KMH_100, np.nextafter(KMH_100, 100.0),
                       np.nextafter(KMH_100, 0.0), 27.7, 27.8])
    inputs = [grid32, grid64, grid32.tolist(), KMH_100, 28.0,
              [10, 27, 28, 40], np.array([[20.0, 33.3], [33.4, 50.0]],
                                         np.float32)]
    t, j = MobilityModel(), JMobility()
    for v in inputs:
        for thr in ((), (20.0,), (33.3,), (np.float32(k32),)):
            got = t.is_blurred(torch.as_tensor(v) if isinstance(
                v, np.ndarray) else v, *thr)
            want = np.asarray(j.is_blurred(v, *thr))
            assert got.dtype == torch.bool
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{v} {thr}")


def _ref_leaves(tree) -> dict:
    """{path: (shard shape, dtype name)} of a reference tree of
    ShapeDtypeStructs with NamedShardings."""
    out = {}
    for p, s in jax.tree_util.tree_flatten_with_path(tree)[0]:
        spec = NamedSharding(s.sharding.mesh, s.sharding.spec)
        out[jsh._path_str(p)] = (tuple(spec.shard_shape(s.shape)),
                                 str(s.dtype))
    return out


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_bytes_match_reference(arch, mesh_name):
    """Every leaf's local shard shape of every workload (train, prefill,
    decode, long_500k; bf16 and int8 caches) is the reference's, each
    dtype is (the int inputs aside), and each group's bytes are the
    sum of its leaves'."""
    tm, jm = _meshes(mesh_name)
    tcfg, jcfg = get_config(arch), j_get_config(arch)
    j_params = _ref_leaves(jst.params_specs(jcfg, jm)[0])
    for shape_name, shape in INPUT_SHAPES.items():
        for kv in ("bf16", "int8"):
            if kv == "int8" and shape.kind != "decode":
                continue
            got = dr.rank_leaves(tcfg, shape, tm, kv_dtype=kv)
            j_inputs = jst.input_specs(jcfg, J_SHAPES[shape_name], jm,
                                       cache_dtype=getattr(jax.numpy,
                                                           J_CACHE[kv]))
            want = {"params": j_params, "inputs": _ref_leaves(
                {k: v for k, v in j_inputs.items() if k != "cache"})}
            if shape.kind == "train":
                want["momentum"] = j_params
            if "cache" in j_inputs:
                want["cache"] = _ref_leaves(j_inputs["cache"])
            assert set(got) == set(want), (shape_name, kv)
            sums = dr.rank_bytes(tcfg, shape, tm, kv_dtype=kv)
            for group, leaves in got.items():
                assert set(leaves) == set(want[group]), (shape_name, group)
                for path, (shp, dtype) in leaves.items():
                    w_shp, w_dtype = want[group][path]
                    assert shp == w_shp, (shape_name, group, path)
                    if path in INT_INPUTS and group == "inputs":
                        assert (dtype, w_dtype) == (torch.int64, "int32")
                    else:
                        assert str(dtype).split(".")[-1] == w_dtype, path
                assert sums[group] == sum(math.prod(s) * d.itemsize
                                          for s, d in leaves.values())
                if group in ("params", "momentum", "cache"):
                    assert sums[group] == sum(
                        math.prod(s) * np.dtype(d).itemsize
                        for s, d in want[group].values()), group
            assert sums["argument_bytes"] == sum(
                v for k, v in sums.items() if k != "argument_bytes")


def test_rank_bytes_on_one_device_are_the_drawn_bytes():
    """On a (1, 1) mesh the arguments are the whole tensors: the drawn
    params (bf16) and tokens of a prefill, and a train step's momentum
    and blur, byte for byte."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import steps as st
    from repro_torch.models import transformer as T
    cfg = get_config("olmoe-1b-7b").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           torch.bfloat16)
    p_bytes = sum(t.nbytes for _, t in leaves_with_paths(params))
    one = dr.ShapeMesh((1, 1), dr.ZOO_AXES)
    shape = InputShape("p", 96, 3, "prefill")
    tokens = torch.zeros((3, 96), dtype=torch.int64)
    assert dr.rank_bytes(cfg, shape, one) == {
        "params": p_bytes, "inputs": tokens.nbytes,
        "argument_bytes": p_bytes + tokens.nbytes}
    mom = st.init_momentum(params)
    train = dr.rank_bytes(cfg, InputShape("t", 96, 3, "train"), one,
                          objective="dt")
    assert train["momentum"] == sum(t.nbytes for _, t in
                                    leaves_with_paths(mom))
    # tokens, blur (float32) and the dt views' drops (2, B, S) bool
    assert train["inputs"] == tokens.nbytes + 3 * 4 + 2 * 3 * 96


def test_collective_bytes_matches_reference_fixture():
    """Records of FIXTURE_HLO's collectives (the functional ops DTensor
    issues, a kind named directly, the async wait of the all-reduce)
    give the reference's parse exactly; the process group's own ops map
    to the same kinds; an op of no kind raises."""
    records = [("all_gather_into_tensor", (2048, 256), torch.bfloat16),
               ("all_reduce", (1024,), torch.float32),
               ("reduce_scatter_tensor", (64, 256), torch.bfloat16),
               ("all_to_all_single", (16, 8, 256), torch.bfloat16),
               ("collective-permute", (32, 32), "f32"),
               ("wait_tensor", (1024,), torch.float32)]
    want = j_collective_bytes(FIXTURE_HLO)
    assert dr.collective_bytes(records) == want
    c10d = [("_allgather_base_", (2048, 256), "bf16"),
            ("allreduce_", (1024,), "f32"),
            ("_reduce_scatter_base_", (64, 256), "bf16"),
            ("alltoall_base_", (16, 8, 256), "bf16"),
            ("collective-permute", (32, 32), "f32")]
    assert dr.collective_bytes(c10d) == want
    assert dr.collective_bytes([]) == {}
    with pytest.raises(ValueError, match="no kind"):
        dr.collective_bytes([("broadcast_", (4,), "f32")])


def _rwkv6_inputs(gen, b=2, s=37, h=3, d=64):
    r, k, v = (torch.randn(b, s, h, d, generator=gen) for _ in range(3))
    logw = -torch.exp(torch.randn(b, s, h, d, generator=gen))
    u = torch.randn(h, d, generator=gen)
    return r, k, v, logw, u


def test_kernels_shape_only_on_fake_tensors_plain_on_cpu():
    """Fake tensors take the shape-only path: outputs of the kernels'
    shapes and dtypes, the operations handed to the listeners, no launch
    counted. Real CPU tensors run the plain versions, as before, and
    tell the listeners nothing."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    seen = []
    ops.SHAPE_ONLY_LISTENERS.append(lambda n, f: seen.append((n, f)))
    try:
        before = ops.launch_counts()
        gen = torch.Generator().manual_seed(0)
        real = _rwkv6_inputs(gen)
        o, st = ops.rwkv6(*real)
        o_ref, st_ref = ops.rwkv6_plain(*real)
        assert torch.equal(o, o_ref) and torch.equal(st, st_ref)
        q = torch.nn.functional.normalize(torch.randn(6, 128, generator=gen),
                                          dim=-1)
        got = ops.dt_loss_fwd(q, q.flip(0), 0.1, 1.0)
        for a, b in zip(got, ops.ref.dt_loss_fwd_ref(q, q.flip(0), 0.1, 1.0)):
            assert torch.equal(a, b)
        assert seen == []
        with FakeTensorMode() as mode:
            fake = [mode.from_tensor(t) for t in real]
            o, st = ops.rwkv6(*fake)
            q32 = torch.empty(16, 1024)
            outs = ops.dt_loss_fwd(q32, q32, 0.1, 1.0)
            cohort = ops.dt_loss_fwd(torch.empty(3, 8, 128),
                                     torch.empty(3, 8, 128), 0.1, 1.0)
        assert isinstance(o, FakeTensor) and o.shape == real[0].shape
        assert o.dtype == st.dtype == torch.float32
        assert st.shape == (2, 3, 64, 64)
        assert [tuple(t.shape) for t in outs] == [(16,)] * 4
        assert [tuple(t.shape) for t in cohort] == [(3, 8)] * 4
        assert seen == [("rwkv6", rwkv6_kernel.work_flops(6, 37, 64)),
                        ("dt_loss_wide", dt_kernel.work_flops(1, 16, 1024)),
                        ("dt_loss", 6 * 3 * 8 * 8 * 128)]
        assert ops.launch_counts() == before
    finally:
        ops.SHAPE_ONLY_LISTENERS.pop()


@pytest.fixture(scope="module")
def worker(tmp_path_factory):
    """tests/torch_dryrun_worker.py's results, run once."""
    out = tmp_path_factory.mktemp("dryrun") / "worker.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, WORKER, str(out)], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=WORKER_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out) as f:
        return json.load(f)


def _case_names():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_dryrun_worker
    return [c[0] for c in torch_dryrun_worker.CASES]


@pytest.mark.parametrize("case", _case_names())
def test_fake_trace_records(worker, case):
    """Each fake trace is ok and has the reference's record keys; its
    argument bytes are those of the steps' own placement at run time;
    the memory adds up (the donated outputs are not counted twice)."""
    rec = worker["cases"][case]
    assert rec["ok"], rec.get("error")
    assert {"flops", "bytes accessed"} <= set(rec["cost"])
    assert rec["cost"]["bytes_basis"] == "aten ops, unfused"
    mem = rec["memory"]
    assert set(mem) >= {"argument_bytes", "output_bytes", "temp_bytes",
                        "peak_bytes"}
    assert mem["argument_bytes"] == mem["arguments"]["argument_bytes"]
    assert 0 < mem["output_bytes"] and 0 < mem["temp_bytes"]
    assert mem["argument_bytes"] < mem["peak_bytes"] <= \
        mem["argument_bytes"] + mem["temp_bytes"]
    assert rec["cost"]["flops"] > 0 and rec["collectives"]
    assert all(k in dr.KINDS or k[len("count_"):] in dr.KINDS
               for k in rec["collectives"])
    if case in worker["placed"]:
        assert mem["argument_bytes"] == worker["placed"][case]
    if "train" in case:
        assert rec["n_micro"] == 1
    if case == "olmoe-train-2x4":      # the expert-parallel exchange
        # two all_to_alls a MoE layer forward, two more backward
        assert rec["collectives"]["count_all-to-all"] == 2 * 2 * 2
    if case.startswith("rwkv6"):       # the kernel's shape-only path
        cfg = get_config("rwkv6-1.6b").reduced()
        heads = cfg.d_model // cfg.rwkv_head_dim
        # 8 sequences over data = 2, the heads over model = 4
        bh = (8 // 2) * (heads // 4)
        assert rec["cost"]["kernel_flops"] == {"rwkv6": cfg.n_layers * (
            rwkv6_kernel.work_flops(bh, 64, cfg.rwkv_head_dim))}
    if case == "tinyllama-dt-2x4":     # the DT kernel on gathered features
        assert rec["cost"]["kernel_flops"] == {
            "dt_loss": dt_kernel.work_flops(1, 8, 256)}


def test_fake_trace_flops_split_over_data(worker):
    """On a (data=4, model=1) mesh each rank does a quarter of the one
    device's matmul FLOPs, in train and prefill, exactly."""
    for kind, flops in worker["flops"].items():
        assert 4 * flops["(4, 1)"] == flops["None"], kind


def test_ops_rwkv6_still_refuses_a_dtensor(worker):
    assert "plain tensors" in worker["dtensor_refused"]


def test_entry_point_records_skips_and_fails_loudly(worker):
    """`main` on the 16x16 fake world: ok records with the reference's
    keys for a prefill and a decode of the reduced tinyllama, an
    ``ok: False`` record with its error and trace for resnet18-cifar (no
    zoo step takes it) and exit code 1; the second run skips the finished
    keys and exits 0. The trace imported neither jax nor repro."""
    first, second = worker["cli"]
    recs = first["records"]
    assert first["code"] == 1 and second["code"] == 0
    for shape in ("prefill_32k", "decode_32k"):
        rec = recs[f"tinyllama-1.1b-smoke|{shape}|single|lm"]
        assert rec["ok"] and rec["mesh"] == "16x16"
        assert rec["world_size"] == 256 and rec["device_type"] == "cpu"
        assert {"arch", "shape", "kind", "objective", "kv_dtype", "cost",
                "collectives", "memory", "trace_s", "total_s", "n_params",
                "n_active_params"} <= set(rec)
        assert rec["n_params"] == get_config(
            "tinyllama-1.1b-smoke").n_params()
    bad = recs["resnet18-cifar|prefill_32k|single|lm"]
    assert not bad["ok"] and bad["error"] and bad["trace"]
    assert sum(line.startswith("[skip]") for line in second["lines"]) == 2
    assert worker["foreign_modules"] == []
