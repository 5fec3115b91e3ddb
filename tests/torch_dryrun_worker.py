"""The worker of tests/test_torch_dryrun.py: runs the dry run's fake
traces (launch/dryrun.py `trace_step`) at the reduced widths on small
fake worlds, in a process of its own so that no process group enters
the pytest worker, and writes what the parent checks to a JSON file.
It imports torch and the port only.

    PYTHONPATH=src python tests/torch_dryrun_worker.py out.json
"""
from __future__ import annotations

import json
import os
import sys
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.convert import leaves_with_paths
from repro_torch.launch import dryrun as dr
from repro_torch.launch import steps as st

B, S = 8, 64                   # a batch of the reduced configs
FLOP_S = 2048                  # long enough that DTensor shards the work
MESHES = {"2x4": (2, 4), "2x2x2": (2, 2, 2)}
# (name, arch, kind, mesh, objective): every record must be ok. The
# dense family's train step runs on (data=2, model=4) only: on the
# three-dim mesh DTensor's search for its redistributions takes minutes
# of host time (torch's, not the trace's)
KINDS = {"2x4": ("train", "prefill", "decode"),
         "2x2x2": ("prefill", "decode")}
CASES = ([(f"tinyllama-{k}-{m}", "tinyllama-1.1b", k, m, "lm")
          for m in MESHES for k in KINDS[m]]
         + [("tinyllama-dt-2x4", "tinyllama-1.1b", "train", "2x4", "dt"),
            ("olmoe-train-2x4", "olmoe-1b-7b", "train", "2x4", "lm"),
            ("rwkv6-prefill-2x4", "rwkv6-1.6b", "prefill", "2x4", "lm")])
# the data-parallel FLOP check: (data=4, model=1) against one device
FLOP_CASES = ("train", "prefill")


def _shape(kind: str, s: int = S) -> InputShape:
    return InputShape(kind, s, B, kind)


def placed_bytes(cfg, shape: InputShape, mesh_shape: tuple) -> int:
    """One rank's argument bytes as the steps place them at run time, in a
    fake world: `shard_params` of the params (and their momentum in
    train), the step's own `_place_batch` of full inputs, and the mesh
    prefill's `_mesh_cache` in decode."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.steps import _long_context, _mesh_cache, \
        _place_batch, enc_ctx_len
    names = dr._names_of(mesh_shape)
    with dr.fake_world(mesh_shape, names, "cpu") as mesh, FakeTensorMode():
        params = st.shard_params(cfg, _empty(cfg), mesh)
        total = sum(t.to_local().nbytes for _, t in leaves_with_paths(params))
        if shape.kind == "train":
            total *= 2
        specs = st.input_specs(cfg, shape, dr.ShapeMesh(mesh_shape, names))
        specs.pop("cache", None)
        full = {k: torch.zeros(p.shape, dtype=p.dtype) for k, p in
                specs.items()}
        total += sum(t.to_local().nbytes
                     for t in _place_batch(full, mesh).values())
        if shape.kind == "decode":
            cache = _mesh_cache(cfg, B, shape.seq_len, dtype=torch.bfloat16,
                                device="cpu",
                                long_context=_long_context(shape),
                                ctx_len=enc_ctx_len(cfg, shape.seq_len),
                                mesh=mesh)
            total += sum(t.to_local().nbytes
                         for _, t in leaves_with_paths(cache))
    return total


def _empty(cfg):
    from repro_torch.convert import tree_map
    from repro_torch.models import transformer as T
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype),
                    T.param_shapes(cfg))


def dtensor_refused() -> str:
    """`ops.rwkv6` on a DTensor in a fake world: the TypeError's text (or
    "" where it does not raise)."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.kernels import ops
    with dr.fake_world((2, 4), dr.ZOO_AXES, "cpu") as mesh:
        x = DTensor.from_local(torch.zeros(1, 4, 1, 64), mesh,
                               [Replicate(), Replicate()])
        try:
            ops.rwkv6(x, x, x, x, torch.zeros(64))
        except TypeError as e:
            return str(e)
    return ""


def cli(tmp: str) -> dict:
    """The entry point twice on the production 16x16 fake world with the
    reduced tinyllama (``-smoke``), a prefill and a decode, then again:
    (exit code, records, printed lines) of each run. The resnet config,
    which no zoo step takes, records its failure."""
    import contextlib
    import io
    path = os.path.join(tmp, "dryrun.json")
    runs = []
    for archs in ("tinyllama-1.1b-smoke,resnet18-cifar",
                  "tinyllama-1.1b-smoke"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            code = dr.main(["--arch", archs, "--shape",
                            "prefill_32k,decode_32k", "--mesh", "single",
                            "--out", path])
        with open(path) as f:
            runs.append({"code": code, "records": json.load(f),
                         "lines": buf.getvalue().splitlines()})
    return runs


def main(out_path: str) -> None:
    out = {"cases": {}, "placed": {}, "flops": {}}
    t0 = time.time()
    for name, arch, kind, mesh, objective in CASES:
        cfg = get_config(arch).reduced()
        try:
            rec = dr.trace_step(cfg, _shape(kind), MESHES[mesh],
                                objective=objective, device="cpu")
            rec["ok"] = True
        except Exception as e:  # recorded for the parent, which fails on it
            rec = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        out["cases"][name] = rec
        if arch == "tinyllama-1.1b" and objective == "lm":
            out["placed"][name] = placed_bytes(cfg, _shape(kind),
                                               MESHES[mesh])
    cfg = get_config("tinyllama-1.1b").reduced()
    for kind in FLOP_CASES:
        out["flops"][kind] = {
            str(m): dr.trace_step(cfg, _shape(kind, FLOP_S), m,
                                  device="cpu")["cost"]["flops"]
            for m in ((4, 1), None)}
    out["dtensor_refused"] = dtensor_refused()
    out["cli"] = cli(os.path.dirname(os.path.abspath(out_path)))
    out["foreign_modules"] = sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
    out["seconds"] = time.time() - t0
    with open(out_path, "w") as f:
        json.dump(dr._jsonable(out), f)


if __name__ == "__main__":
    main(sys.argv[1])
