"""Checkpoints: npz round trip with a structural spec — counterpart of
`repro.checkpoint.store` (`save`, `restore`, `latest`, `save_state`,
`restore_state`), writing and reading the same format, so a checkpoint
of either package restores in the other.

    save(path, step, tree) / restore(path) -> (step, tree)
    latest(dir) -> (path, step) from the LATEST pointer, or None

A tree is nested dicts, lists, tuples and None over leaves (torch
tensors, numpy arrays and scalars, Python numbers). The npz holds:
* ``leaf_i``: the leaves in jax's flatten order (dicts in sorted-key
  order, sequences in order, None an empty subtree), each a numpy array
  of its exact dtype (int64 and float64 stay so: the host MT19937 state
  round-trips bitwise); a bfloat16 leaf as its raw 16 bits with a
  ``dtype_i`` tag (numpy has no bfloat16);
* ``__spec__``: the JSON structural spec that `restore(path)` rebuilds the
  nesting from, with no example tree;
* ``__step__`` and ``__treedef__`` (a plain string describing the
  structure; the reference writes jax's treedef string there and its
  structural restore does not read it either).

Every file (the npz, ``LATEST``, the sidecar) is written to a temporary
name in its directory and renamed onto its own (`os.replace`), so a
reader sees the previous file or the whole new one, never part of one.
A sharded campaign's rank 0 alone writes its checkpoints
(core/engine.py).

`restore` returns numpy leaves, bfloat16 ones as torch.bfloat16 tensors.
`restore(path, like)` checks the shapes against `like` and hangs the
leaves on its structure, as torch tensors on the device of each torch
leaf of `like`.

`save_state` / `restore_state` checkpoint a whole `FLState`
(`FLState.to_tree`, `FLState.from_tree`); with a `Scenario`, a sidecar
``<path>.meta.json`` holds the experiment's fingerprint, the same in
both packages for the same Scenario, and `restore_state` refuses a
checkpoint of another experiment. The port's state holds the CPU
generator's state (`gen_state`) where the reference's holds its jax
`key`: restoring a file the reference wrote needs ``gen_state=`` given
explicitly, and the reference restoring the port's file needs a key.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Tuple

import numpy as np
import torch


def _leaves(tree) -> list:
    """The leaves in jax's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for c in tree for x in _leaves(c)]
    return [tree]


def _spec(tree, count: list) -> dict:
    """JSON-able structural spec; leaf numbers follow `_leaves`."""
    if tree is None:
        return {"t": "none"}
    if isinstance(tree, dict):
        keys = sorted(tree)
        return {"t": "dict", "k": keys,
                "c": [_spec(tree[k], count) for k in keys]}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {"t": kind, "c": [_spec(x, count) for x in tree]}
    count[0] += 1
    return {"t": "leaf", "i": count[0] - 1}


def _unspec(spec, leaves) -> Any:
    t = spec["t"]
    if t == "none":
        return None
    if t == "dict":
        return {k: _unspec(c, leaves) for k, c in zip(spec["k"], spec["c"])}
    if t == "list":
        return [_unspec(c, leaves) for c in spec["c"]]
    if t == "tuple":
        return tuple(_unspec(c, leaves) for c in spec["c"])
    if t != "leaf":
        raise ValueError(f"unknown node {t!r} in a checkpoint spec")
    return leaves[spec["i"]]


def _describe(spec) -> str:
    """The structure as a plain string, jax's treedef notation."""
    t = spec["t"]
    if t == "leaf":
        return "*"
    if t == "none":
        return "None"
    if t == "dict":
        return "{" + ", ".join(f"{k!r}: {_describe(c)}"
                               for k, c in zip(spec["k"], spec["c"])) + "}"
    inner = ", ".join(_describe(c) for c in spec["c"])
    if t == "list":
        return f"[{inner}]"
    return f"({inner},)" if len(spec["c"]) == 1 else f"({inner})"


def _leaf_arrays(i: int, leaf) -> dict:
    """`leaf_i` (and `dtype_i` for bfloat16) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return {f"leaf_{i}": t.view(torch.int16).numpy().view(np.uint16),
                    f"dtype_{i}": np.frombuffer(b"bfloat16", np.uint8)}
        return {f"leaf_{i}": t.numpy()}
    a = np.asarray(leaf)
    if a.dtype.kind == "V":     # an ml_dtypes bfloat16 array
        return {f"leaf_{i}": a.view(np.uint16 if a.dtype.itemsize == 2
                                    else np.uint8),
                f"dtype_{i}": np.frombuffer(str(a.dtype).encode(), np.uint8)}
    return {f"leaf_{i}": a}


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _write_replacing(path: str, write) -> None:
    """`write(f)` into a temporary file beside `path` (opened "wb"), then
    that file renamed onto `path`; the temporary file is removed if
    `write` raises."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            write(f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _write_json(path: str, obj) -> None:
    _write_replacing(path, lambda f: f.write(json.dumps(obj).encode()))


def save(path: str, step: int, tree) -> str:
    """Write `tree` at `step` to the npz `path` (``.npz`` appended where
    it lacks it, as `np.savez` does) and point LATEST at it."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    arrays = {}
    for i, leaf in enumerate(_leaves(tree)):
        arrays.update(_leaf_arrays(i, leaf))
    spec = _spec(tree, [0])
    _write_replacing(_npz(path), lambda f: np.savez(
        f, __step__=np.int64(step),
        __treedef__=np.frombuffer(
            f"PyTreeDef({_describe(spec)})".encode(), np.uint8),
        __spec__=np.frombuffer(json.dumps(spec).encode(), np.uint8),
        **arrays))
    _write_json(os.path.join(d, "LATEST"),
                {"path": os.path.basename(path), "step": step})
    return path


def _load_leaf(z, i: int):
    a = z[f"leaf_{i}"]
    if f"dtype_{i}" not in z:
        return a
    tag = bytes(z[f"dtype_{i}"]).decode()
    if tag != "bfloat16":
        raise ValueError(f"checkpoint leaf {i} has dtype {tag!r}; the port "
                         f"restores bfloat16 raw bits only")
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
        torch.bfloat16)


def _like_leaf(new, old):
    """`new` as a torch tensor on `old`'s device when `old` is one."""
    if not isinstance(old, torch.Tensor):
        return new
    t = new if isinstance(new, torch.Tensor) else torch.from_numpy(
        np.array(new))
    return t.to(old.device)


def _rebuild(like, it):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(like[k], it) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        children = [_rebuild(c, it) for c in like]
        if isinstance(like, list):
            return children
        return (type(like)(*children) if hasattr(like, "_fields")
                else tuple(children))
    return _like_leaf(next(it), like)


def restore(path: str, like: Any = None) -> Tuple[int, Any]:
    """(step, tree) of a checkpoint. With `like=None` the structure comes
    from the stored spec; with an example tree the leaves are checked
    against its shapes and hung on its structure (named tuples included,
    which the spec records as plain tuples)."""
    path = _npz(path)
    with np.load(path) as z:
        step = int(z["__step__"])
        if like is None:
            if "__spec__" not in z:
                raise ValueError(
                    f"{path} predates structural specs; pass an example "
                    f"tree via restore(path, like)")
            spec = json.loads(bytes(z["__spec__"]).decode())
            n = sum(1 for k in z.files if k.startswith("leaf_"))
            return step, _unspec(spec, [_load_leaf(z, i) for i in range(n)])
        old = _leaves(like)
        new = [_load_leaf(z, i) for i in range(len(old))]
    for i, (a, b) in enumerate(zip(old, new)):
        if tuple(np.shape(a)) != tuple(b.shape):
            raise ValueError(f"checkpoint leaf {i} shape mismatch: "
                             f"{tuple(np.shape(a))} vs {tuple(b.shape)}")
    return step, _rebuild(like, iter(new))


def latest(ckpt_dir: str):
    """(path, step) the LATEST pointer of `ckpt_dir` names, or None."""
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        meta = json.load(f)
    return os.path.join(ckpt_dir, meta["path"]), meta["step"]


# -- FLState ----------------------------------------------------------------

def _scenario_fingerprint(scenario) -> dict:
    """FLConfig's fields, the topology's name and its static parameters:
    the same dict, field for field, as the reference's for the same
    Scenario (so a checkpoint refuses another experiment in either
    package)."""
    sig = scenario.topology.signature()
    return {"cfg": dataclasses.asdict(scenario.cfg),
            "topology": scenario.topology.name,
            "topology_params": {k: v for k, v in sig.items() if k != "name"}}


def save_state(path: str, state, scenario=None) -> str:
    """Checkpoint a whole `FLState` at its round; with `scenario`, stamp
    it with the experiment's fingerprint (the ``.meta.json`` sidecar)."""
    p = save(path, state.round, state.to_tree())
    if scenario is not None:
        _write_json(_npz(p) + ".meta.json", _scenario_fingerprint(scenario))
    return p


def _check_fingerprint(path: str, scenario) -> None:
    meta_path = path + ".meta.json"
    if not os.path.exists(meta_path):
        return
    with open(meta_path) as f:
        stored = json.load(f)
    want = json.loads(json.dumps(_scenario_fingerprint(scenario)))
    if stored == want:
        return
    diff = [k for k in want["cfg"] if stored["cfg"].get(k) != want["cfg"][k]]
    if stored["topology"] != want["topology"]:
        diff.append("topology")
    if stored.get("topology_params") != want["topology_params"]:
        diff.append("topology_params")
    raise ValueError(f"checkpoint {path} was written by a different "
                     f"experiment (mismatched: {diff}); refusing to resume. "
                     f"Pass scenario=None to override.")


def restore_state(path: str, scenario=None, device=None, gen_state=None):
    """The `FLState` of a `save_state` checkpoint (its round is the step),
    its tensors on `device` (default: the scenario's, else CUDA).

    With `scenario`, a stored fingerprint must match it. A checkpoint the
    reference wrote holds a jax key and no generator state: it restores
    only with ``gen_state=`` (a CPU torch.Generator state) given, which
    also takes the place of any stored one."""
    from repro_torch.core.state import FLState
    from repro_torch.runtime import resolve_device

    path = _npz(path)
    if scenario is not None:
        _check_fingerprint(path, scenario)
        if device is None:
            device = scenario.device
    _, tree = restore(path)
    return FLState.from_tree(tree, device=resolve_device(device),
                             gen_state=gen_state)
