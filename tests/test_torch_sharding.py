"""The port's sharding rules (launch/sharding.py) against the reference's
(`repro.launch.sharding`), spec for spec, on the CPU with no process
group: device-free meshes on both sides (the port's `ShapeMesh`, the
reference's `AbstractMesh`) at the production shapes (16, 16) and (2,
16, 16) and the tests' (2, 4); the port's shape-only trees
(`transformer.param_shapes`, `init_cache` on ``meta``) against
`jax.eval_shape` of the reference's inits at full width.

Every leaf of every architecture's parameters, the batch spec at
divisible and indivisible batches, every family's cache (bfloat16 and
int8), the KV preference chain, the `input_specs` of each workload
kind, and the per-device bf16 bytes of params plus momentum of the four
largest architectures on the multi-pod mesh (the reference's
tests/test_sharding.py bound, 16 GB a chip) must be equal. The spec
placements are checked too.

    PYTHONPATH=src python -m pytest tests/test_torch_sharding.py
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import abstract_mesh
from repro.configs.base import InputShape as JShape
from repro.configs.base import get_config as j_get_config
from repro.configs.base import list_configs as j_list_configs
from repro.launch import sharding as jsh
from repro.launch import steps as jst
from repro.models import transformer as JT
from repro_torch.configs import get_config, list_configs
from repro_torch.configs.base import InputShape
from repro_torch.convert import leaves_with_paths
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.launch import steps as tst
from repro_torch.models import transformer as TT

ARCHS = [a for a in list_configs() if a != "resnet18-cifar"]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
BIG = ["kimi-k2-1t-a32b", "deepseek-67b", "llama-3.2-vision-90b",
       "gemma2-27b"]


def _meshes(name):
    shape, names = MESHES[name]
    return tmesh.ShapeMesh(shape, names), abstract_mesh(shape, names)


def _ref_specs(tree, shardings) -> dict:
    """{path: spec tuple} of a reference tree of NamedShardings."""
    flat = jax.tree_util.tree_flatten_with_path(shardings)[0]
    return {jsh._path_str(p): tuple(s.spec) for p, s in flat}


def _port_specs(specs) -> dict:
    return {"/".join(p): s for p, s in leaves_with_paths(specs)}


def test_list_configs_matches_reference():
    assert list_configs() == j_list_configs()


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_params_shardings_match_reference(arch, mesh_name):
    """Every parameter leaf's spec, at full width (shape-only trees), and
    `params_specs`' shapes, dtypes and specs."""
    tm, jm = _meshes(mesh_name)
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    vlm = jcfg.family == "vlm"
    j_shape = jax.eval_shape(
        lambda: JT.init_params(jcfg, jax.random.PRNGKey(0),
                               dtype=jnp.bfloat16))
    want = _ref_specs(j_shape, jsh.params_shardings(jm, j_shape, vlm=vlm))
    placed, specs = tst.params_specs(tcfg, tm)
    got = _port_specs(specs)
    assert got == want
    j_leaves = {jsh._path_str(p): leaf for p, leaf in
                jax.tree_util.tree_flatten_with_path(j_shape)[0]}
    for path, p in leaves_with_paths(placed):
        key = "/".join(path)
        assert p.shape == j_leaves[key].shape, key
        assert p.spec == got[key]
        assert str(p.dtype).split(".")[-1] == str(j_leaves[key].dtype), key


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_spec_and_sanitize_match_reference(mesh_name):
    """`param_spec` with and without FSDP and a stacked prefix, and
    `sanitize`'s prefix fallback, on assorted shapes."""
    tm, jm = _meshes(mesh_name)
    from jax.sharding import PartitionSpec as P
    for spec, shape in ((("model", None), (25, 64)), (("model", None),
                        (32, 64)), ((("data", "model"), None), (48, 64)),
                        ((("pod", "data"), "model"), (6, 48)),
                        ((None, ("data", "model")), (3, 512))):
        if any(a not in tmesh.axis_names(tm) for e in spec if e is not None
               for a in ((e,) if isinstance(e, str) else e)):
            continue
        assert tsh.sanitize(tm, spec, shape) == \
            tuple(jsh.sanitize(jm, P(*spec), shape))
    for path, shape, stacked in (("blocks/attn/wq", (4, 2048, 2048), 1),
                                 ("blocks/moe/w_up", (4, 64, 2048, 1024), 1),
                                 ("embed", (32000, 2048), 0),
                                 ("probe", (256, 256), 0),
                                 ("blocks/ln1/scale", (4, 2048), 1)):
        for fsdp in (True, False):
            assert tsh.param_spec(tm, path, shape, fsdp=fsdp,
                                  stacked_prefix=stacked) == tuple(
                jsh.param_spec(jm, path, shape, fsdp=fsdp,
                               stacked_prefix=stacked))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_spec_matches_reference(mesh_name):
    """Divisible and indivisible batches: over (pod, data), data alone, or
    replicated."""
    tm, jm = _meshes(mesh_name)
    for b in (1, 2, 3, 8, 16, 24, 32, 48, 128, 256, 512):
        assert tsh.batch_spec(tm, b) == tuple(jsh.batch_spec(jm, b)), b
        assert tsh.tokens_sharding(tm, b) == \
            tuple(jsh.tokens_sharding(jm, b).spec), b


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_cache_shardings_match_reference(mesh_name, dtype):
    """Every family's cache (rings, positions, int8 scales, rwkv and SSM
    states, conv, ctx) at the reference's test shapes (128 sequences of
    1024 positions, a 64-row context)."""
    tm, jm = _meshes(mesh_name)
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (jnp.int8, torch.int8))
    for arch in ARCHS:
        jcfg, tcfg = j_get_config(arch), get_config(arch)
        j_cache = jax.eval_shape(lambda: JT.init_cache(
            jcfg, 128, 1024, dtype=jd, ctx_len=64))
        want = _ref_specs(j_cache, jsh.cache_shardings(jm, j_cache, 128))
        t_cache = TT.init_cache(tcfg, 128, 1024, dtype=td, device="meta",
                                ctx_len=64)
        got = _port_specs(tsh.cache_shardings(tm, t_cache, 128))
        assert got == want, arch


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_kv_cache_spec_matches_reference(mesh_name):
    """The KV preference chain (heads, else W, else head_dim) on shapes
    that take each branch, with and without the layer prefix."""
    tm, jm = _meshes(mesh_name)
    m = dict(zip(*reversed(MESHES[mesh_name])))["model"]
    for shape in ((4, 64, 1024, m * 2, 64), (4, 64, 1024, 3, 64),
                  (4, 64, 1000, 3, 64 * m), (4, 64, 1001, 3, 7)):
        for bax in ("data", None):
            for prefix in (1, 0):
                shp = shape[1 - prefix:]
                assert tsh.kv_cache_spec(tm, shp, bax, prefix) == tuple(
                    jsh.kv_cache_spec(jm, shp, bax, prefix)), (shp, prefix)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b",
                                  "seamless-m4t-large-v2",
                                  "llama-3.2-vision-90b", "rwkv6-1.6b"])
def test_input_specs_match_reference(arch, kind):
    """`input_specs`' shapes and specs of each workload kind at the
    production mesh: the tokens (int64 in the port, int32 in the
    reference), blur, frames or patches, positions and the cache."""
    tm, jm = _meshes("16x16")
    b, s = (32, 1024) if kind != "decode" else (128, 2048)
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    want = jst.input_specs(jcfg, JShape("w", s, b, kind), jm)
    got = tst.input_specs(tcfg, InputShape("w", s, b, kind), tm)
    w_flat = {jsh._path_str(p): x for p, x in
              jax.tree_util.tree_flatten_with_path(want)[0]}
    g_flat = {"/".join(p): x for p, x in leaves_with_paths(got)}
    assert set(g_flat) == set(w_flat)
    for k, x in g_flat.items():
        assert x.shape == w_flat[k].shape, k
        assert x.spec == tuple(w_flat[k].sharding.spec), k


def _per_device_bytes(mesh, specs, shapes) -> int:
    total = 0
    sizes = tmesh.axis_sizes(mesh)
    for path, spec in specs.items():
        n = math.prod(shapes[path])
        for axes in spec:
            if axes is not None:
                n //= math.prod(sizes[a] for a in ((axes,) if isinstance(
                    axes, str) else axes))
        total += n * 2                                   # bf16
    return total


@pytest.mark.parametrize("arch", BIG)
def test_big_arch_bytes_per_device_match_reference(arch):
    """bf16 params plus momentum a device on the multi-pod mesh: the
    port's specs give the reference's bytes, under its 16 GB a chip."""
    tm, jm = _meshes("2x16x16")
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    j_shape = jax.eval_shape(
        lambda: JT.init_params(jcfg, jax.random.PRNGKey(0),
                               dtype=jnp.bfloat16))
    j_specs = _ref_specs(j_shape, jsh.params_shardings(
        jm, j_shape, vlm=jcfg.family == "vlm"))
    shapes = {jsh._path_str(p): l.shape for p, l in
              jax.tree_util.tree_flatten_with_path(j_shape)[0]}
    placed, specs = tst.params_specs(tcfg, tm)
    got = _per_device_bytes(tm, _port_specs(specs), shapes)
    assert got == _per_device_bytes(tm, j_specs, shapes)
    assert got * 2 / 1e9 < 16.0


def test_shape_mesh_and_placements():
    """`ShapeMesh` carries names and sizes; a spec becomes one placement a
    mesh dim (a tuple entry in the mesh's order, the major split
    first); a tuple against the mesh's order raises."""
    from torch.distributed.tensor import Replicate, Shard
    m = tmesh.ShapeMesh((2, 16, 16), ("pod", "data", "model"))
    assert tmesh.axis_sizes(m) == {"pod": 2, "data": 16, "model": 16}
    assert tmesh.batch_axes(m) == ("pod", "data")
    assert tsh.placements_of(m, (("pod", "data"), "model")) == (
        Shard(0), Shard(0), Shard(1))
    assert tsh.placements_of(m, (None, "model", None)) == (
        Replicate(), Replicate(), Shard(1))
    with pytest.raises(ValueError, match="order"):
        tsh.placements_of(m, (("data", "pod"),))
    with pytest.raises(ValueError, match="length"):
        tmesh.ShapeMesh((2, 4), ("data",))


def test_param_shapes_match_init_params():
    """The shape-only tree is `init_params`' tree, leaf for leaf."""
    cfg = get_config("olmoe-1b-7b-smoke")
    real = TT.init_params(cfg, torch.Generator().manual_seed(0),
                          torch.bfloat16)
    meta = TT.param_shapes(cfg)
    for (p, a), (q, b) in zip(leaves_with_paths(real),
                              leaves_with_paths(meta)):
        assert p == q and a.shape == b.shape and a.dtype == b.dtype
        assert b.is_meta


def test_pick_n_micro_per_shard_matches_reference():
    """`pick_n_micro` with a mesh: the reference's per-shard rule."""
    for arch in ("tinyllama-1.1b", "deepseek-67b", "kimi-k2-1t-a32b"):
        jcfg, tcfg = j_get_config(arch), get_config(arch)
        for name in MESHES:
            tm, jm = _meshes(name)
            for s, b in ((4096, 256), (4096, 32), (512, 8)):
                assert tst.pick_n_micro(tcfg, InputShape("t", s, b, "train"),
                                        tm) == jst.pick_n_micro(
                    jcfg, JShape("t", s, b, "train"), jm), (arch, name, s, b)
