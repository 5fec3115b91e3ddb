"""Abstract registry contract checker over fake tensors — counterpart of
`repro.analysis.contracts` (the same rule ids, `Violation`, check
functions, geometries, tiny config and printed summary).

Every registry the experiment layer dispatches through has a structural
contract the rest of the port assumes:

  SCHEME_WEIGHTS   (cohort, cfg) -> (n,) float weights over the VALID
                   rows only (a scheme that reads ``cohort.blur`` instead
                   of ``cohort.valid_blur`` returns (m,) on a padded
                   cohort).
  AGGREGATORS      (cohort, cfg) -> the model tree: the reference's keys,
                   leaf shapes and dtypes, in its ravel order
                   (convert.py), identical whatever the padding m >= n.
  CLIENT_UPDATES   run_cohort(..., parallel=True) returns (CohortBatch,
                   uploads) whose cohort carries the float32 validity
                   mask, the same valid count it was given, and the
                   trained trees as the port's flat cohort: ``flat`` the
                   (m, P) float32 rows and ``spec`` the model tree's
                   ``flat_spec`` (the reference stacks the trees instead;
                   core/cohort.py).
  TOPOLOGIES       default-constructible strategy classes exposing the
                   Topology API with a JSON-able ``signature()``.
  CODECS           encode(rows, base, ef) -> (payload, new_ef) with a
                   payload of tensors, and decode(payload, base) giving
                   back the (m, P) float32 rows (the port's codecs work on
                   flat rows, comms/codecs.py); stateful codecs hand back
                   a residual of the shape they were given and declare a
                   round-0 state, stateless ones declare neither.
  serve framing    (contract-serve) encode_snapshot / decode_snapshot
                   round-trip ONE model tree back to the model tree with
                   every leaf shape and dtype intact, through a non-empty
                   payload; a framing through the rows decodes to one
                   (1, P) float32 row.

All checks run the registry entries over FAKE CPU tensors
(`torch._subclasses.fake_tensor.FakeTensorMode`): the full-width
ResNet-18-CIFAR tree (P = 11,506,624) and its cohorts carry shapes and
dtypes only, so nothing is allocated and no FLOP is spent. Not `meta`
tensors, since `kernels.ops` refuses a device that is neither CUDA nor
the CPU; not fake CUDA tensors, since the CUDA wrappers hand data
pointers to ctypes. So the contracts interpret each kernel's plain
version; the kernels' own shapes are held on the card against those
plain versions (chip_smoke.py). An entry that reads data (``.item()``,
``int(tensor)``, ``.tolist()``, boolean indexing) raises under fake
tensors and is reported as ``contract-eval-error``.

Run from the repo root::

    python -m repro_torch.analysis.contracts

Registries are injectable (``check_all(aggregators=..., ...)``) so
tests/test_torch_analysis.py can verify the checker flags deliberately
broken entries with the right rule id.
"""
from __future__ import annotations

import json
import sys
from dataclasses import dataclass
from typing import List, Mapping, Optional, Sequence

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import get_config
from repro_torch.convert import flat_spec, leaves_with_paths, ravel
from repro_torch.core import aggregation as agg
from repro_torch.core import clients as clients_mod
from repro_torch.core import topology as topo_mod
from repro_torch.core.cohort import CohortBatch
from repro_torch.core.state import FLConfig
from repro_torch.models.resnet import init_resnet

__all__ = [
    "Violation",
    "abstract_cohort",
    "check_aggregators",
    "check_all",
    "check_client_updates",
    "check_codecs",
    "check_scheme_weights",
    "check_serve",
    "check_topologies",
    "main",
    "model_tree_fake",
]

# Rule ids (the analysis-wide namespace also holds the lint rules).
RULE_TREEDEF = "contract-treedef"
RULE_MASK = "contract-mask"
RULE_WEIGHT_SHAPE = "contract-weight-shape"
RULE_WEIGHT_DTYPE = "contract-weight-dtype"
RULE_TOPOLOGY_API = "contract-topology-api"
RULE_CODEC = "contract-codec"
RULE_SERVE = "contract-serve"
RULE_EVAL_ERROR = "contract-eval-error"


@dataclass(frozen=True)
class Violation:
    registry: str
    entry: str
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.registry}[{self.entry}]: {self.rule}: {self.message}"


# --------------------------------------------------------------------------
# abstract fixtures
# --------------------------------------------------------------------------

def _check_cfg(**over) -> FLConfig:
    """Tiny config: shapes only matter structurally over fake tensors."""
    base = dict(n_vehicles=8, vehicles_per_round=3, batch_size=2,
                local_iters=1, queue_len=16, feature_dim=128)
    base.update(over)
    return FLConfig(**base)


def model_tree_fake(arch: str = "resnet18-cifar") -> dict:
    """The model tree as fake CPU tensors (shapes and dtypes, no storage).
    Call inside a `FakeTensorMode`."""
    return init_resnet(get_config(arch), torch.Generator(), device="cpu")


def abstract_cohort(tree, n: int, m: int) -> CohortBatch:
    """A CohortBatch of fake tensors over `tree`: n valid rows padded to
    m. Call inside the `FakeTensorMode` that made `tree`."""
    if not 1 <= n <= m:
        raise ValueError(f"valid count {n} not in [1, {m}]")
    spec = flat_spec(tree)

    def vec():
        return torch.empty((m,), dtype=torch.float32)

    return CohortBatch(flat=torch.empty((m, spec.size), dtype=torch.float32),
                       spec=spec, losses=vec(), mask=vec(), n=n,
                       velocities=vec(), blur=vec())


def _keystr(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _diff_trees(expected, got) -> Optional[str]:
    """First structural difference between two trees of tensors (nested
    dicts; a bare tensor is a one-leaf tree), or None."""
    exp, act = leaves_with_paths(expected), leaves_with_paths(got)
    exp_paths, act_paths = [p for p, _ in exp], [p for p, _ in act]
    if exp_paths != act_paths:
        missing = [p for p in exp_paths if p not in act_paths][:1]
        extra = [p for p in act_paths if p not in exp_paths][:1]
        return (f"treedef mismatch: expected {len(exp_paths)} leaves, got "
                f"{len(act_paths)} (first missing "
                f"{[_keystr(p) for p in missing]}, first unexpected "
                f"{[_keystr(p) for p in extra]})")
    for (path, leaf), (_, other) in zip(exp, act):
        where = _keystr(path) or "<root>"
        if not isinstance(other, torch.Tensor):
            return f"leaf {where} is a {type(other).__name__}, not a tensor"
        if tuple(other.shape) != tuple(leaf.shape):
            return (f"leaf {where} shape {tuple(other.shape)} "
                    f"!= expected {tuple(leaf.shape)}")
        if other.dtype != leaf.dtype:
            return (f"leaf {where} dtype {other.dtype} "
                    f"!= expected {leaf.dtype}")
    return None


def _has_leaves(payload) -> bool:
    return any(isinstance(leaf, torch.Tensor)
               for _, leaf in leaves_with_paths(payload))


# --------------------------------------------------------------------------
# per-registry checks
# --------------------------------------------------------------------------

# (n, m) cohort geometries every entry is interpreted under: the unpadded
# cohort and a bucketed one. Schemes/aggregators must be invariant to m.
_GEOMETRIES = ((3, 3), (3, 5))


def check_scheme_weights(schemes: Optional[Mapping] = None,
                         cfg: Optional[FLConfig] = None) -> List[Violation]:
    schemes = agg.SCHEME_WEIGHTS if schemes is None else schemes
    cfg = cfg or _check_cfg()
    out: List[Violation] = []
    with FakeTensorMode():
        tree = model_tree_fake()
        for name, fn in sorted(schemes.items()):
            for n, m in _GEOMETRIES:
                cohort = abstract_cohort(tree, n, m)
                try:
                    w = fn(cohort, cfg)
                    shape = tuple(w.shape)
                except Exception as e:  # noqa: BLE001 - report, don't crash
                    out.append(Violation(
                        "SCHEME_WEIGHTS", name, RULE_EVAL_ERROR,
                        f"raised over fake tensors at (n={n}, m={m}): "
                        f"{e!r}"))
                    break
                if shape != (n,):
                    hint = (" — weights computed on the padded rows; use "
                            "cohort.valid_blur / the valid-prefix views"
                            if shape == (m,) and m != n else "")
                    out.append(Violation(
                        "SCHEME_WEIGHTS", name, RULE_WEIGHT_SHAPE,
                        f"weights shape {shape} != ({n},) at "
                        f"(n={n}, m={m}){hint}"))
                    break
                if not w.dtype.is_floating_point:
                    out.append(Violation(
                        "SCHEME_WEIGHTS", name, RULE_WEIGHT_DTYPE,
                        f"weights dtype {w.dtype} is not floating "
                        f"(aggregation multiplies f32 model leaves)"))
                    break
    return out


def check_aggregators(aggregators: Optional[Mapping] = None,
                      cfg: Optional[FLConfig] = None) -> List[Violation]:
    aggregators = agg.AGGREGATORS if aggregators is None else aggregators
    cfg = cfg or _check_cfg()
    out: List[Violation] = []
    with FakeTensorMode():
        tree = model_tree_fake()
        for name, fn in sorted(aggregators.items()):
            for n, m in _GEOMETRIES:
                cohort = abstract_cohort(tree, n, m)
                try:
                    result = fn(cohort, cfg)
                except Exception as e:  # noqa: BLE001
                    out.append(Violation(
                        "AGGREGATORS", name, RULE_EVAL_ERROR,
                        f"raised over fake tensors at (n={n}, m={m}): "
                        f"{e!r}"))
                    break
                diff = _diff_trees(tree, result)
                if diff is not None:
                    out.append(Violation(
                        "AGGREGATORS", name, RULE_TREEDEF,
                        f"output is not the model tree at (n={n}, m={m}): "
                        f"{diff}"))
                    break
    return out


def _check_one_client(name: str, entry, cfg: FLConfig, tree) -> List[Violation]:
    """One entry over the fake model tree: n fake (B, 4, 4, 3) batches,
    the (pi1, pi2) draws of the round's plan (`topology._pi_draws`, from
    a generator seeded with cfg.seed) and a 0-d float32 lr."""
    n = cfg.vehicles_per_round
    batches = [torch.empty((cfg.batch_size, 4, 4, 3), dtype=torch.float32)
               for _ in range(n)]
    lr = torch.empty((), dtype=torch.float32)

    def bad(rule, msg):
        return Violation("CLIENT_UPDATES", name, rule, msg)

    try:
        draws = topo_mod._pi_draws(torch.Generator().manual_seed(cfg.seed),
                                   cfg, n)
        state = entry.init_state(cfg, tree)
        cohort, _uploads = entry.run_cohort(cfg, tree, state, batches, draws,
                                            lr, parallel=True)
    except Exception as e:  # noqa: BLE001
        return [bad(RULE_EVAL_ERROR, f"raised over fake tensors: {e!r}")]

    if not isinstance(cohort, CohortBatch):
        return [bad(RULE_MASK,
                    f"run_cohort returned {type(cohort).__name__}, not a "
                    f"CohortBatch — the validity mask was dropped")]
    out: List[Violation] = []
    m = tuple(cohort.losses.shape)[0] if cohort.losses.dim() else 0
    if cohort.mask is None:
        out.append(bad(RULE_MASK, "CohortBatch.mask is None"))
    else:
        if tuple(cohort.mask.shape) != (m,):
            out.append(bad(RULE_MASK,
                           f"mask shape {tuple(cohort.mask.shape)} != "
                           f"losses' cohort axis ({m},)"))
        if not cohort.mask.dtype.is_floating_point:
            out.append(bad(RULE_MASK,
                           f"mask dtype {cohort.mask.dtype} is not the "
                           f"float32 validity convention"))
    if cohort.n != n:
        out.append(bad(RULE_MASK,
                       f"valid count changed: ran {n} clients, "
                       f"CohortBatch.n == {cohort.n}"))
    spec = flat_spec(tree)
    diff = _diff_trees(torch.empty((m, spec.size), dtype=torch.float32),
                       cohort.flat)
    if diff is None and cohort.spec != spec:
        diff = "spec is not the model tree's flat_spec"
    if diff is not None:
        out.append(bad(RULE_TREEDEF,
                       f"the cohort is not the model tree's (m, P) float32 "
                       f"rows: {diff}"))
    return out


def check_client_updates(client_updates: Optional[Mapping] = None,
                         cfg: Optional[FLConfig] = None) -> List[Violation]:
    client_updates = (clients_mod.CLIENT_UPDATES if client_updates is None
                      else client_updates)
    out: List[Violation] = []
    with FakeTensorMode():
        tree = model_tree_fake()
        for name, entry in sorted(client_updates.items()):
            entry_cfg = cfg or _check_cfg(client=name if name in
                                          clients_mod.CLIENT_UPDATES
                                          else None)
            out.extend(_check_one_client(name, entry, entry_cfg, tree))
    return out


def check_topologies(topologies: Optional[Mapping] = None) -> List[Violation]:
    topologies = topo_mod.TOPOLOGIES if topologies is None else topologies
    out: List[Violation] = []
    for name, cls in sorted(topologies.items()):
        def bad(rule, msg):
            return Violation("TOPOLOGIES", name, rule, msg)
        for method in ("init_state", "run_round", "signature", "validate"):
            if not callable(getattr(cls, method, None)):
                out.append(bad(RULE_TOPOLOGY_API,
                               f"missing Topology API method {method!r}"))
        try:
            instance = cls()
        except Exception as e:  # noqa: BLE001
            out.append(bad(RULE_TOPOLOGY_API,
                           f"not default-constructible: {e!r}"))
            continue
        if getattr(instance, "name", None) != name:
            out.append(bad(RULE_TOPOLOGY_API,
                           f"instance.name {getattr(instance, 'name', None)!r}"
                           f" != registry key {name!r}"))
        try:
            sig = instance.signature()
            json.dumps(sig)
        except Exception as e:  # noqa: BLE001
            out.append(bad(RULE_TOPOLOGY_API,
                           f"signature() is not JSON-able: {e!r}"))
            continue
        if not isinstance(sig, dict) or sig.get("name") != name:
            out.append(bad(RULE_TOPOLOGY_API,
                           f"signature() must be a dict carrying "
                           f"name={name!r}; got {sig!r}"))
    return out


def check_codecs(codecs: Optional[Mapping] = None,
                 cfg: Optional[FLConfig] = None) -> List[Violation]:
    """The comms-codec roundtrip contract over fake tensors: for every
    cohort geometry, decode(encode(rows)) must give back the (m, P)
    float32 rows (aggregation runs on the reconstruction), and the
    error-feedback residual must keep the shape it was given (it scatters
    back into ``FLState.comms``)."""
    from repro_torch.comms import codecs as codecs_mod
    codecs = codecs_mod.CODECS if codecs is None else codecs
    out: List[Violation] = []
    with FakeTensorMode():
        tree = model_tree_fake()
        base = ravel(tree)
        for name, codec in sorted(codecs.items()):
            def bad(rule, msg):
                return Violation("CODECS", name, rule, msg)
            for _, m in _GEOMETRIES:
                entry_cfg = cfg or _check_cfg(vehicles_per_round=m)
                rows = torch.empty((m, base.shape[0]), dtype=torch.float32)
                try:
                    state = codec.init_state(entry_cfg, tree)
                    if codec.stateful:
                        payload, new_ef = codec.encode(rows, base,
                                                       state["ef"])
                    else:
                        payload, new_ef = codec.encode(rows, base)
                    decoded = codec.decode(payload, base)
                except Exception as e:  # noqa: BLE001 - report, don't crash
                    out.append(bad(RULE_EVAL_ERROR,
                                   f"raised over fake tensors at m={m}: "
                                   f"{e!r}"))
                    break
                diff = _diff_trees(rows, decoded)
                if diff is not None:
                    out.append(bad(RULE_CODEC,
                                   f"decode(encode(...)) is not the cohort "
                                   f"rows at m={m}: {diff}"))
                    break
                if not _has_leaves(payload):
                    out.append(bad(RULE_CODEC, "encode returned an empty "
                                               "payload"))
                    break
                if codec.stateful:
                    ef = state["ef"] if isinstance(state, dict) else None
                    if ef is None:
                        out.append(bad(RULE_CODEC,
                                       "stateful codec without an 'ef' "
                                       "slot in init_state"))
                        break
                    if new_ef is None or \
                            tuple(new_ef.shape) != tuple(ef.shape):
                        got = None if new_ef is None else tuple(new_ef.shape)
                        out.append(bad(RULE_CODEC,
                                       f"residual shape {got} != the "
                                       f"{tuple(ef.shape)} it was given"))
                        break
                elif state is not None or new_ef is not None:
                    out.append(bad(RULE_CODEC,
                                   "stateless codec declared cross-round "
                                   "state (init_state / new_ef not None)"))
                    break
    return out


def check_serve(codecs: Optional[Mapping] = None) -> List[Violation]:
    """The serving tier's snapshot-framing contract over fake tensors: for
    every CODECS entry, ``encode_snapshot`` on a single model tree
    (against a base of the same tree — what `ModelStore.publish` hands it
    from the `run_campaign` publish hook) must yield a non-empty payload,
    and ``decode_snapshot`` must invert it back to the model tree with
    every leaf shape/dtype intact — the tree a vehicle reconstructs. Every
    codec but ``identity`` frames the tree as one row, so its decode must
    give one (1, P) float32 row before the framing unravels it."""
    from repro_torch.comms import codecs as codecs_mod
    from repro_torch.comms.codecs import decode_snapshot, encode_snapshot
    codecs = codecs_mod.CODECS if codecs is None else codecs
    out: List[Violation] = []
    with FakeTensorMode():
        tree = model_tree_fake()
        one_row = ravel(tree)[None]
        for name, codec in sorted(codecs.items()):
            def bad(rule, msg):
                return Violation("CODECS", name, rule, msg)
            try:
                payload = encode_snapshot(codec, tree, tree)
                rows = (None if codec.name == "identity"
                        else codec.decode(payload, one_row[0]))
            except Exception as e:  # noqa: BLE001 - report, don't crash
                out.append(bad(RULE_EVAL_ERROR,
                               f"snapshot framing raised over fake "
                               f"tensors: {e!r}"))
                continue
            if not _has_leaves(payload):
                out.append(bad(RULE_SERVE, "encode_snapshot returned an "
                                           "empty payload"))
                continue
            diff = None if rows is None else _diff_trees(one_row, rows)
            if diff is not None:
                out.append(bad(RULE_SERVE,
                               f"the snapshot's decoded rows are not one "
                               f"(1, P) float32 row: {diff}"))
                continue
            try:
                decoded = decode_snapshot(codec, payload, tree)
            except Exception as e:  # noqa: BLE001 - report, don't crash
                out.append(bad(RULE_EVAL_ERROR,
                               f"decode_snapshot raised over fake "
                               f"tensors: {e!r}"))
                continue
            diff = _diff_trees(tree, decoded)
            if diff is not None:
                out.append(bad(RULE_SERVE,
                               f"decode_snapshot(encode_snapshot(tree)) is "
                               f"not the model tree: {diff}"))
    return out


def check_all(*, schemes: Optional[Mapping] = None,
              aggregators: Optional[Mapping] = None,
              client_updates: Optional[Mapping] = None,
              topologies: Optional[Mapping] = None,
              codecs: Optional[Mapping] = None) -> List[Violation]:
    """Check every registry (real ones by default, injectable for tests)."""
    out: List[Violation] = []
    out.extend(check_scheme_weights(schemes))
    out.extend(check_aggregators(aggregators))
    out.extend(check_client_updates(client_updates))
    out.extend(check_topologies(topologies))
    out.extend(check_codecs(codecs))
    out.extend(check_serve(codecs))
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    violations = check_all()
    for v in violations:
        print(str(v), file=sys.stderr)
    from repro_torch.comms import codecs as codecs_mod
    n_entries = (len(agg.SCHEME_WEIGHTS) + len(agg.AGGREGATORS)
                 + len(clients_mod.CLIENT_UPDATES) + len(topo_mod.TOPOLOGIES)
                 + len(codecs_mod.CODECS))
    if violations:
        print(f"contracts: {len(violations)} violation(s) across "
              f"{n_entries} registry entries", file=sys.stderr)
        return 1
    print(f"contracts: {n_entries} registry entries OK "
          f"(SCHEME_WEIGHTS={len(agg.SCHEME_WEIGHTS)}, "
          f"AGGREGATORS={len(agg.AGGREGATORS)}, "
          f"CLIENT_UPDATES={len(clients_mod.CLIENT_UPDATES)}, "
          f"TOPOLOGIES={len(topo_mod.TOPOLOGIES)}, "
          f"CODECS={len(codecs_mod.CODECS)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
