"""Dry run of the zoo's mesh steps on a fake world — counterpart of
`repro.launch.dryrun` (`DTYPE_BYTES`, `collective_bytes`, `dryrun_one`,
`main`).

The reference lowers and compiles every (architecture x input shape x
mesh) step on 512 host placeholder devices and records XLA's
`memory_analysis()`, `cost_analysis()` and the HLO's collective bytes
into benchmarks/results/dryrun.json. The port traces its own steps
instead: a fake process group of 256 or 512 ranks (this process is rank
0; `torch.distributed`'s ``fake`` backend, which sends nothing) under a
`DeviceMesh` of the production shape and names ((data=16, model=16) or
(pod=2, data=16, model=16)), and `FakeTensorMode`, under which no tensor
holds memory. The params are drawn as fake tensors and placed by
`steps.shard_params`, the inputs by `steps.input_specs`; then the port's
own `make_train_step` (n_micro from `pick_n_micro`, as the reference's),
`make_prefill_step` or `make_decode_step` with ``mesh=`` runs once. A
dispatch mode of this module's own (`_TraceMode`) sees every aten op
that runs on rank 0's local shards, and every collective DTensor or the
model issues, and records:

* ``cost``: ``flops``, the matmul-class ops' FLOPs
  (`torch.utils.flop_counter`'s formulas) plus the operation counts of
  the hand-written kernels the step reaches (``kernel_flops``: on fake
  tensors `kernels.ops` takes its shape-only path and reports them);
  ``bytes accessed``, the operand and result bytes of every op that
  reads or writes memory (views and allocations touch none), with
  ``bytes_basis`` "aten ops, unfused", and ``bytes accessed output``,
  the result bytes alone. All per rank, as ``cost_analysis`` is per
  device. The layers run in a Python loop, so the counts are at full
  depth: the reference's ``calibrate_one`` (it extrapolates XLA's
  counts, which see a scan body once) is not ported, nor its
  ``--calibrate`` flag.
* ``collectives``: `collective_bytes` of the collectives observed, the
  reference's kinds (all-gather, all-reduce, reduce-scatter,
  all-to-all, collective-permute), their result bytes and counts.
* ``memory``: ``argument_bytes`` (`rank_bytes`: the local shards of the
  params, the momentum in train, the inputs, the cache in decode),
  ``output_bytes`` (the local bytes of the step's outputs),
  ``temp_bytes`` (the peak of the fake storages alive inside the step
  that it allocated) and ``peak_bytes`` (the arguments plus that peak,
  with the reference's donation: the new params and momentum in train,
  the new cache in decode, are written over their arguments and not
  counted twice).

`rank_bytes` computes the per-rank arguments from the specs alone, on a
`launch.mesh.ShapeMesh` or a `DeviceMesh`, with nothing allocated and
no process group. `trace_step` runs one step on any mesh shape (the
tests and chip_smoke.py run small worlds) or on one device.

The entry point computes nothing on a device and allocates no device
memory, like the reference's 512 host placeholders: it needs no card. A
build of torch with CUDA traces on a ``cuda`` mesh, so that DTensor
picks the collectives NCCL would run; a build without CUDA cannot index
a fake CUDA tensor, so it traces on a ``cpu`` mesh, where DTensor turns
a shard-to-shard move into an all-gather and a chunk (``device_type``
in the record says which). The fake process group is internal to torch
(`torch.testing._internal.distributed.fake_pg`), and the trace needs a
process of its own: it raises where a process group exists.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch a,b]
        [--shape s,..] [--mesh single,multi] [--objective lm|dt]
        [--kv-dtype bf16|int8] [--force] [--out build/dryrun_torch.json]

Finished keys (``arch|shape|mesh|objective``) in `--out` are skipped
unless `--force`; a failed combination is recorded with ``ok: False``,
its ``error`` and its ``trace``, and the run exits with code 1.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import (INPUT_SHAPES, InputShape, get_config,
                                      list_configs)
from repro_torch.convert import leaves_with_paths, tree_map, unflatten
from repro_torch.launch import sharding as sh
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import (ZOO_AXES, ZOO_AXES_MULTI_POD,
                                     ShapeMesh, axis_sizes)

ROOT = os.path.normpath(os.path.join(os.path.dirname(
    os.path.abspath(__file__)), "..", "..", ".."))
DEFAULT_OUT = os.path.join(ROOT, "build", "dryrun_torch.json")

DTYPE_BYTES = {"f32": 4, "bf16": 2, "f16": 2, "s32": 4, "u32": 4, "s8": 1,
               "u8": 1, "pred": 1, "f64": 8, "s64": 8, "u64": 8,
               "f8e4m3fn": 1, "f8e5m2": 1, "s16": 2, "u16": 2}
DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
               torch.float16: "f16", torch.int32: "s32", torch.uint32: "u32",
               torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred",
               torch.float64: "f64", torch.int64: "s64", torch.uint64: "u64",
               torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2",
               torch.int16: "s16", torch.uint16: "u16"}
CACHE_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8}
# the reference's production meshes, by the --mesh flag's names
MESHES = {"single": (16, 16), "multi": (2, 16, 16)}
MESH_NAMES = {"single": "16x16", "multi": "2x16x16"}

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
# the collectives a trace observes, by op name, as the reference's kinds:
# torch's functional collectives (DTensor's), the process group's own
# (torch.distributed's, the model's expert-parallel all_to_all), and the
# kinds themselves (a record may name its kind)
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather", "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    **{k: k for k in KINDS},
}
# an async collective's wait, counted with its collective (the
# reference skips the "-done" half of an async pair)
ASYNC_WAITS = ("wait_tensor",)
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")


# --------------------------------------------------------------------------
# per-rank accounting (no process group, nothing allocated)
# --------------------------------------------------------------------------

def _local_shape(mesh, shape, spec) -> tuple:
    """The shape of one rank's shard of a `shape` tensor placed by `spec`
    on `mesh` (a `ShapeMesh` or a `DeviceMesh`): each dim divided by the
    sizes of the mesh axes its entry names (`sanitize` keeps only axes
    that divide)."""
    sizes = axis_sizes(mesh)
    out = []
    for n, axes in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                        - len(spec))):
        if axes is not None:
            names = (axes,) if isinstance(axes, str) else axes
            n //= math.prod(sizes[a] for a in names)
        out.append(n)
    return tuple(out)


def rank_leaves(cfg, shape: InputShape, mesh, *, objective: str = "lm",
                kv_dtype: str = "bf16") -> dict:
    """{group: {path: (local shape, dtype)}} of one rank's step arguments:
    ``params`` (bf16, `steps.params_specs`), ``momentum`` in train (the
    params' shapes and shardings, as the reference's), ``inputs``
    (`steps.input_specs` without the cache: a ``dt`` train step's
    ``drops`` too) and ``cache`` in decode (`kv_dtype`: ``bf16`` or
    ``int8``). Shapes from the specs; nothing is allocated."""
    placed, _ = st.params_specs(cfg, mesh)

    def shards(tree) -> dict:
        return {"/".join(path): (_local_shape(mesh, p.shape, p.spec), p.dtype)
                for path, p in leaves_with_paths(tree)}

    groups = {"params": shards(placed)}
    if shape.kind == "train":
        groups["momentum"] = dict(groups["params"])
    specs = st.input_specs(cfg, shape, mesh,
                           cache_dtype=CACHE_DTYPES[kv_dtype],
                           objective=objective)
    cache = specs.pop("cache", None)
    groups["inputs"] = shards(specs)
    if cache is not None:
        groups["cache"] = shards(cache)
    return groups


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def rank_bytes(cfg, shape: InputShape, mesh, *, objective: str = "lm",
               kv_dtype: str = "bf16") -> dict:
    """One rank's argument bytes of a step on `mesh` (a `ShapeMesh` or a
    `DeviceMesh`): each group of `rank_leaves` summed (``params``,
    ``momentum`` in train, ``inputs``, ``cache`` in decode) and their
    total, ``argument_bytes``."""
    out = {g: sum(_nbytes(*x) for x in leaves.values())
           for g, leaves in rank_leaves(cfg, shape, mesh, objective=objective,
                                        kv_dtype=kv_dtype).items()}
    out["argument_bytes"] = sum(out.values())
    return out


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------

def _dtype_bytes(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        dtype = DTYPE_NAMES.get(dtype, str(dtype))
    return DTYPE_BYTES.get(dtype, 4)


def collective_bytes(ops) -> dict:
    """The reference's collective summary of observed collectives: `ops`
    is an iterable of (op or kind, result shape, dtype) records (dtype a
    `torch.dtype` or a `DTYPE_BYTES` name); returns {kind: result bytes,
    "count_" + kind: records} for each kind seen. An async wait
    (``wait_tensor``) is its collective's other half and is skipped; an
    op of no kind raises ValueError."""
    out: dict = {}
    for op, shape, dtype in ops:
        if op in ASYNC_WAITS:
            continue
        kind = COLLECTIVE_KINDS.get(op)
        if kind is None:
            raise ValueError(f"collective {op!r} has no kind; known: "
                             f"{sorted(COLLECTIVE_KINDS)}")
        out[kind] = out.get(kind, 0) + math.prod(shape) * _dtype_bytes(dtype)
        out["count_" + kind] = out.get("count_" + kind, 0) + 1
    return out


# --------------------------------------------------------------------------
# the traced step
# --------------------------------------------------------------------------

def _tensors(tree) -> list:
    from torch.utils._pytree import tree_flatten
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _bytes_of(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _no_access_ops() -> frozenset:
    """Ops that read and write no tensor memory: allocations and
    metadata."""
    a = torch.ops.aten
    return frozenset({a.empty.memory_format, a.empty_strided.default,
                      a.empty_like.default, a.new_empty.default,
                      a.new_empty_strided.default, a.lift_fresh.default,
                      torch.ops.prim.device.default})


class _TraceMode(TorchDispatchMode):
    """The dispatch mode of a trace: on every op of plain (local) tensors
    it adds the matmul FLOPs, the bytes touched and the collectives, and
    follows the fake storages the ops allocate (each storage's bytes from
    its first appearance to its finalisation) as a series of
    (allocation id, +/- bytes) events; `arguments`' storages are not
    followed. DTensor ops are left to DTensor, whose local ops then come
    through here. `kernel` is the shape-only kernels' listener."""

    def __init__(self, arguments):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        from torch.utils.weak import WeakIdKeyDictionary
        super().__init__()
        self._dtensor, self._flop_registry = DTensor, flop_registry
        self._no_access = _no_access_ops()
        self.flops = 0
        self.kernel_flops: dict = {}
        self.bytes_accessed = 0
        self.bytes_output = 0
        self.collectives: list = []
        self.events: list = []
        self._ids = WeakIdKeyDictionary()
        for t in arguments:
            self._ids[t.untyped_storage()] = None
        self.paused = False

    @contextlib.contextmanager
    def _pause(self, real: bool = False):
        """Ops in the block are no rank's work and are not recorded; with
        `real`, tensors made in it are real (no fake mode), so that
        DTensor's index arithmetic can read them."""
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        was, self.paused = self.paused, True
        try:
            with unset_fake_temporarily() if real else \
                    contextlib.nullcontext():
                yield
        finally:
            self.paused = was

    @contextlib.contextmanager
    def around_dtensor_bookkeeping(self):
        """Within the block, DTensor's own bookkeeping runs paused: the ops
        its sharding propagation runs to learn an op's global output
        shape (on fake tensors of the global shapes, once an op
        signature), and a strided shard's offsets, which it reads from an
        arange by ``tolist()`` (real here, since a fake tensor has no
        values to read). Methods torch does not have are left alone."""
        from torch.distributed.tensor import placement_types
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        targets = [(ShardingPropagator, n, False) for n in (
            "_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")]
        targets.append((getattr(placement_types, "_StridedShard", None),
                        "local_shard_size_and_offset", True))
        patched = []
        try:
            for owner, name, real in targets:
                orig = owner.__dict__.get(name) if owner is not None else None
                if orig is None or any(o is owner for o, _, _ in patched):
                    continue

                def paused(*args, _orig=getattr(owner, name), _real=real,
                           **kwargs):
                    with self._pause(_real):
                        return _orig(*args, **kwargs)

                setattr(owner, name, functools.wraps(orig)(paused))
                patched.append((owner, name, orig))
            yield
        finally:
            for owner, name, orig in patched:
                setattr(owner, name, orig)

    def kernel(self, name: str, flops: int) -> None:
        self.flops += flops
        self.kernel_flops[name] = self.kernel_flops.get(name, 0) + flops

    def alloc_id(self, t):
        """The allocation id of `t`'s storage (None: an argument's)."""
        return self._ids.get(t.untyped_storage())

    def _follow(self, ts) -> None:
        for t in ts:
            s = t.untyped_storage()
            if s in self._ids:
                continue
            i, n = len(self.events), s.nbytes()
            self._ids[s] = i
            self.events.append((i, n))
            weakref.finalize(s, self.events.append, (i, -n))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.paused:
            return out
        outs = _tensors(out)
        if func.namespace in _COLLECTIVE_NAMESPACES:
            op = func.overloadpacket.__name__
            # a process group's op writes its first argument in place
            res = _tensors(args[0]) if func.namespace == "c10d" else outs
            self.collectives += [(op, tuple(t.shape), t.dtype) for t in res]
        else:
            packet = func.overloadpacket
            if packet in self._flop_registry:
                self.flops += self._flop_registry[packet](*args, **kwargs,
                                                          out_val=out)
            if not func.is_view and func not in self._no_access:
                written = _bytes_of(outs)
                self.bytes_output += written
                self.bytes_accessed += written + _bytes_of(
                    _tensors((args, kwargs)))
        self._follow(outs)
        return out


def _peak(events, skip=frozenset()) -> int:
    live = peak = 0
    for i, n in events:
        if i not in skip:
            live += n
            peak = max(peak, live)
    return peak


def device_type() -> str:
    """The mesh's device type for a trace: ``cuda`` where torch is built
    with CUDA (a card need not be present), else ``cpu``."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


@contextlib.contextmanager
def fake_world(mesh_shape: tuple, names: tuple, device: str):
    """A `DeviceMesh` of `mesh_shape` named `names` on `device` over a
    fake process group of prod(mesh_shape) ranks (this process rank 0),
    destroyed on exit. It is built here and not by `launch.mesh.zoo_mesh`,
    whose groups must have a backend that computes; the fake one sends
    nothing."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group exists: a dry run makes its own "
                           "fake world, in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(mesh_shape))
    try:
        # analysis: allow=retrace-ctor -- one mesh a fake world, which
        # lives for one trace
        yield init_device_mesh(device, tuple(mesh_shape),
                               mesh_dim_names=tuple(names))
    finally:
        dist.destroy_process_group()


def _names_of(mesh_shape: tuple) -> tuple:
    if len(mesh_shape) == 2:
        return ZOO_AXES
    if len(mesh_shape) == 3:
        return ZOO_AXES_MULTI_POD
    raise ValueError(f"a zoo mesh is (data, model) or (pod, data, model), "
                     f"got {mesh_shape}")


def _step(cfg, shape: InputShape, mesh, objective: str):
    """(the step, n_micro or None, whether it takes the momentum, the
    indices of its outputs written over its arguments)."""
    if shape.kind == "train":
        fn, nm = st.make_train_step(cfg, shape, mesh, objective=objective)
        return fn, nm, True, (0, 1)
    if shape.kind == "prefill":
        return st.make_prefill_step(cfg, shape, mesh=mesh), None, False, ()
    return st.make_decode_step(cfg, shape, mesh=mesh), None, False, (1,)


def trace_step(cfg, shape: InputShape, mesh_shape: tuple | None = (16, 16),
               *, objective: str = "lm", kv_dtype: str = "bf16",
               device: str | None = None) -> dict:
    """One step of `cfg` at `shape` on a fake world of `mesh_shape` (named
    ZOO_AXES or ZOO_AXES_MULTI_POD by its length), or on one device where
    `mesh_shape` is None; `device` is the mesh's device type
    (`device_type()` by default). Returns the record's ``cost``,
    ``collectives``, ``memory``, ``n_micro`` (train), ``trace_s`` (the
    step's host seconds), ``device_type`` and ``world_size``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    device = device or device_type()
    if mesh_shape is None:
        world = contextlib.nullcontext()
        acct = ShapeMesh((1, 1), ZOO_AXES)
    else:
        names = _names_of(tuple(mesh_shape))
        world = fake_world(tuple(mesh_shape), names, device)
        acct = ShapeMesh(tuple(mesh_shape), names)
    groups = rank_bytes(cfg, shape, acct, objective=objective,
                        kv_dtype=kv_dtype)
    with world as mesh, FakeTensorMode():
        def put(tree):
            leaves = []
            for _, p in leaves_with_paths(tree):
                t = torch.zeros(p.shape, dtype=p.dtype, device=device)
                leaves.append(t if mesh is None else
                              sh.shard_like(t, mesh, p.spec))
            return unflatten(leaves, tree)

        meta = T.param_shapes(cfg, torch.bfloat16)
        params = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                   device=device), meta)
        if mesh is not None:
            params = st.shard_params(cfg, params, mesh)
        batch = put(st.input_specs(cfg, shape, acct if mesh is None else
                                   mesh, cache_dtype=CACHE_DTYPES[kv_dtype],
                                   objective=objective))
        fn, n_micro, train, donated = _step(cfg, shape, mesh, objective)
        args = (params, st.init_momentum(params), batch) if train \
            else (params, batch)
        local_args = [_local(t) for t in _tensors(args)]
        have = _bytes_of(local_args)
        if have != groups["argument_bytes"]:
            raise AssertionError(f"the placed arguments hold {have} bytes a "
                                 f"rank; rank_bytes says "
                                 f"{groups['argument_bytes']}")
        mode = _TraceMode(local_args)
        ops.SHAPE_ONLY_LISTENERS.append(mode.kernel)
        try:
            t0 = time.time()
            with mode, mode.around_dtensor_bookkeeping():
                out = fn(*args)
            trace_s = time.time() - t0
        finally:
            ops.SHAPE_ONLY_LISTENERS.remove(mode.kernel)
        outs = [_local(t) for t in _tensors(out)]
        skip = {mode.alloc_id(_local(t)) for i in donated
                for t in _tensors(out[i])} - {None}
        memory = {"argument_bytes": groups["argument_bytes"],
                  "output_bytes": _bytes_of(outs),
                  "temp_bytes": _peak(mode.events),
                  "peak_bytes": groups["argument_bytes"]
                  + _peak(mode.events, skip),
                  "arguments": groups}
        rec = {"cost": {"flops": float(mode.flops),
                        "bytes accessed": float(mode.bytes_accessed),
                        "bytes accessed output": float(mode.bytes_output),
                        "bytes_basis": "aten ops, unfused",
                        "flops_basis": "matmul-class aten ops "
                                       "(torch.utils.flop_counter) and the "
                                       "hand-written kernels' operations",
                        "kernel_flops": dict(mode.kernel_flops)},
               "collectives": collective_bytes(mode.collectives),
               "memory": memory, "trace_s": round(trace_s, 2),
               "device_type": device,
               "world_size": math.prod(mesh_shape) if mesh_shape else 1}
        if n_micro is not None:
            rec["n_micro"] = n_micro
    return rec


def _jsonable(d):
    if isinstance(d, dict):
        return {k: _jsonable(v) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return [_jsonable(v) for v in d]
    if isinstance(d, (int, float, str, bool)) or d is None:
        return d
    return str(d)


def dryrun_one(arch: str, shape_name: str, multi_pod: bool,
               objective: str = "lm", kv_dtype: str = "bf16") -> dict:
    """The record of one (arch, shape, mesh) combination on the
    production mesh (256 or 512 fake ranks)."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh = "multi" if multi_pod else "single"
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": MESH_NAMES[mesh],
                 "kind": shape.kind, "objective": objective,
                 "kv_dtype": kv_dtype}
    t0 = time.time()
    rec.update(trace_step(cfg, shape, MESHES[mesh], objective=objective,
                          kv_dtype=kv_dtype))
    rec["total_s"] = round(time.time() - t0, 2)
    rec["n_params"] = cfg.n_params()
    rec["n_active_params"] = cfg.n_active_params()
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--objective", default="lm", choices=["lm", "dt"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--kv-dtype", default="bf16", choices=list(CACHE_DTYPES))
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    archs = (args.arch.split(",") if args.arch else
             [a for a in list_configs() if a != "resnet18-cifar"])
    shapes = args.shape.split(",") if args.shape else list(INPUT_SHAPES)
    meshes = args.mesh.split(",")

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    results, failed = {}, 0
    if os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            results = json.load(f)

    for arch in archs:
        for shape in shapes:
            for m in meshes:
                key = f"{arch}|{shape}|{m}|{args.objective}"
                if results.get(key, {}).get("ok") and not args.force:
                    print(f"[skip] {key}")
                    continue
                print(f"[dryrun] {key} ...", flush=True)
                try:
                    rec = dryrun_one(arch, shape, m == "multi",
                                     args.objective, args.kv_dtype)
                    rec["ok"] = True
                    coll = sum(v for k, v in rec["collectives"].items()
                               if not k.startswith("count_"))
                    print(f"  ok: trace={rec['trace_s']}s "
                          f"flops={rec['cost']['flops']:.3e} "
                          f"coll={coll:.3e}B "
                          f"peak={rec['memory']['peak_bytes']:.3e}B",
                          flush=True)
                except Exception as e:
                    rec = {"ok": False, "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                    print(f"  FAIL: {rec['error']}", flush=True)
                    failed += 1
                results[key] = _jsonable(rec)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)

    n_ok = sum(1 for r in results.values() if r.get("ok"))
    print(f"\n{n_ok}/{len(results)} combos OK -> {args.out}")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
