"""Trace-hygiene AST linter for the port — counterpart of
`repro.analysis.lint`, with the same `Finding`, `Suppressions`, baseline
mechanics, CLI, rule ids and comment syntax, and torch triggers.

The port only keeps its round on the card while no host sync, no
per-round capture or build, and no draw outside the planned generators
creeps into the hot path. The rule classes, and what fires them here:

  host-sync       ``host-sync-cast`` (float()/int() on a non-trivial
                  expression inside a hot scope, as in the reference),
                  ``host-sync-fetch`` (``.item()``, ``.cpu()``,
                  ``.tolist()``, ``.numpy()``, ``torch.cuda.synchronize``,
                  ``.synchronize()`` on a stream or event, ``np.asarray`` /
                  ``np.array`` inside a hot scope).
  retrace-hazard  ``retrace-ctor`` (``torch.cuda.CUDAGraph``,
                  ``torch.cuda.graph``, ``torch.compile``,
                  ``init_device_mesh`` / ``DeviceMesh``, ``dist.new_group``,
                  ``ctypes.CDLL`` constructed inside an uncached function),
                  ``retrace-fresh-array`` (``torch.tensor``,
                  ``torch.as_tensor``, ``torch.from_numpy``, ``torch.full``,
                  ``torch.zeros``, ``torch.ones``, ``torch.arange``,
                  ``torch.linspace``, ``torch.eye`` in a hot scope: a host
                  constant built, and often uploaded, every call).
                  ``retrace-static-unhashable`` keeps its id and hint but
                  cannot fire: the port has no jit cache keyed on static
                  arguments (a campaign's graph is keyed on the scenario,
                  core/engine.py `_campaign_key`).
  purity          ``purity-global-mutation`` (``global`` rebinding, as in
                  the reference), ``purity-np-random`` (the process-global
                  numpy RNG, and the global torch RNG: ``torch.manual_seed``,
                  ``torch.seed``, ``torch.cuda.manual_seed[_all]``; the
                  samplers ``torch.rand/randn/randint/randperm/normal/
                  bernoulli/multinomial`` and the in-place ``.uniform_``,
                  ``.normal_``, ``.bernoulli_``, ``.random_``,
                  ``.exponential_`` without ``generator=``; the ``*_like``
                  samplers, which take no generator), since every draw of
                  the port comes from a planned CPU ``torch.Generator``;
                  ``purity-fresh-prngkey`` (a ``torch.Generator(...)``
                  made inside a hot scope instead of threaded from
                  ``FLState.gen_state`` through ``state.generator_from``).

Hot scopes are functions whose names match ``HOT_NAME_RE`` (the
reference's round / engine / aggregation vocabulary plus the port's own
hot functions) and anything nested inside them; retrace and purity rules
apply everywhere.

Suppression is explicit and auditable, in the reference's syntax, so one
comment serves both linters:

  * ``# analysis: sanctioned-sync -- <reason>`` on the offending line
    marks a designed host<->device fetch point (suppresses the
    host-sync rules there);
  * ``# analysis: allow=<rule-id> -- <reason>`` suppresses one rule on
    that line;
  * ``src/repro_torch/analysis/baseline.json`` pins the accepted
    pre-existing findings (fingerprinted by path + rule + source text, so
    line drift does not invalidate it). ``analysis/baseline.json`` stays
    the reference's.

CLI (exit 0 iff no unsuppressed, non-baselined findings), from the repo
root:

    python -m repro_torch.analysis.lint src/repro_torch
    python -m repro_torch.analysis.lint src/repro_torch --write-baseline

Pure stdlib: it imports neither torch nor anything of `repro`.
"""
from __future__ import annotations

import argparse
import ast
import json
import os
import re
import sys
from collections import Counter
from dataclasses import dataclass, field
from typing import Iterable, List, Optional

DEFAULT_BASELINE = os.path.join("src", "repro_torch", "analysis",
                                "baseline.json")

# Function names that constitute the per-round / per-dispatch hot path:
# the reference's vocabulary, then the port's own hot functions (the
# batched client step, the engine's packing, bodies and replays, the
# sharded and handover plans, the codec stage, the zoo's steps). Nested
# functions inherit hotness from their enclosing scope.
HOT_NAME_RE = re.compile(
    r"^(run_round|run_cohort|run_campaign|plan_round|body|_scan"
    r"|local_train|loss_fn|_record_fetch|_client_images|_client_batch"
    r"|_draw_batches|_cohort_plan|_sample_cohort|_plan_\w+|_client_batches"
    r"|aggregate\w*|_weighted\w+|cohort_weighted_sum|sharded_\w+"
    r"|two_stage\w+|wagg\w*|finalize|_mesh_aggregate|region_view"
    r"|client_step|train_chunks|train_sharded|_cohort_round"
    r"|_handover_round|_build_\w+_body|replay|_graph_rounds|_run_rounds"
    r"|draw_round|roundtrip_cohort|make_grad_fn|run_prefill"
    r"|run_decode)$")

# Constructors whose per-call cost is a capture, a mesh or group, a
# compile or a library load.
RETRACE_CTORS = {
    "torch.cuda.CUDAGraph", "CUDAGraph", "torch.cuda.graph",
    "torch.compile", "init_device_mesh",
    "torch.distributed.device_mesh.init_device_mesh", "DeviceMesh",
    "torch.distributed.device_mesh.DeviceMesh", "dist.new_group",
    "torch.distributed.new_group", "ctypes.CDLL", "CDLL",
}

# torch constructors: fresh host constants (and uploads) when called per
# round.
FRESH_ARRAY_CTORS = {
    "torch.tensor", "torch.as_tensor", "torch.from_numpy", "torch.full",
    "torch.zeros", "torch.ones", "torch.arange", "torch.linspace",
    "torch.eye",
}

# host fetches, by dotted name and by method name (``synchronize`` covers
# ``torch.cuda.synchronize`` and a stream's or an event's)
FETCH_CALLS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array",
               "onp.asarray"}
FETCH_METHODS = {"item", "cpu", "tolist", "numpy", "synchronize"}

# the global torch RNG: seeding, the samplers that take `generator=`, the
# `*_like` samplers (no generator at all) and the in-place samplers
TORCH_GLOBAL_SEED = {"torch.manual_seed", "torch.seed",
                     "torch.cuda.manual_seed", "torch.cuda.manual_seed_all"}
TORCH_SAMPLERS = {"torch.rand", "torch.randn", "torch.randint",
                  "torch.randperm", "torch.normal", "torch.bernoulli",
                  "torch.multinomial"}
TORCH_LIKE_SAMPLERS = {"torch.rand_like", "torch.randn_like",
                       "torch.randint_like"}
INPLACE_SAMPLERS = {"uniform_", "normal_", "bernoulli_", "random_",
                    "exponential_"}

# Caching decorators that make in-function construction a non-hazard.
CACHING_DECORATORS = {
    "functools.lru_cache", "lru_cache", "functools.cache", "cache",
    "functools.cached_property", "cached_property",
}

_ALLOW_RE = re.compile(
    r"#\s*analysis:\s*(?:allow=(?P<rules>[\w,-]+)|(?P<sync>sanctioned-sync))"
    r"(?:\s*--\s*(?P<reason>.*))?")

HOST_SYNC_RULES = ("host-sync-cast", "host-sync-fetch")

RULE_HINTS = {
    "host-sync-cast":
        "float()/int() on a CUDA tensor blocks until it is fetched — "
        "keep losses/stats on the card and fetch once per round or chunk "
        "(core/engine.py run_campaign), or mark the line "
        "'# analysis: sanctioned-sync -- <why>'",
    "host-sync-fetch":
        "device fetches belong at the sanctioned once-per-round/chunk "
        "points; move the fetch there or mark it "
        "'# analysis: sanctioned-sync -- <why>' (a CPU plan tensor syncs "
        "nothing: '# analysis: allow=host-sync-fetch -- CPU plan tensor')",
    "retrace-ctor":
        "construct graphs, meshes, groups and kernel libraries once, at "
        "module scope or behind functools.lru_cache (launch/mesh.py "
        "cohort_mesh is the pattern); per-call construction re-captures, "
        "re-builds or re-enumerates devices every round",
    "retrace-static-unhashable":
        "static_argnums/static_argnames must be hashable (tuple, not "
        "list/dict) or every call re-keys the jit cache",
    "retrace-fresh-array":
        "hoist the constant to module scope, an lru_cache'd helper or "
        "the round's planned inputs — rebuilding it per call makes a "
        "host tensor (and an upload) every round",
    "purity-global-mutation":
        "registry entries are pure functions of (state, scenario); "
        "rebind state through FLState.replace, not module globals",
    "purity-np-random":
        "draw from the packed RandomState threaded through FLState "
        "(core/state.py pack/unpack_host_rng) or a CPU torch.Generator "
        "passed as generator=, never the process-global numpy or torch "
        "RNG — global draws break bit-reproducible schedules",
    "purity-fresh-prngkey":
        "thread FLState.gen_state through state.generator_from instead "
        "of making a fresh torch.Generator — a fresh generator forks the "
        "reproducible draw chain",
}


@dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str
    code: str            # stripped source line (fingerprint component)

    @property
    def hint(self) -> str:
        return RULE_HINTS.get(self.rule, "")

    def fingerprint(self) -> str:
        """Line-number-free identity used by the baseline: path + rule +
        source text. Duplicate texts are disambiguated by count, not
        index, so unrelated edits above a finding never invalidate it."""
        return f"{self.path}::{self.rule}::{self.code}"

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule}: "
                f"{self.message}\n    {self.code}\n    hint: {self.hint}")


@dataclass
class Suppressions:
    """Per-file `# analysis:` comment directives, by line number.

    A directive is statement-aware: inline (or on a comment line inside
    a multi-line statement) it covers that whole statement; on a
    comment-only line it covers the simple statement starting directly
    below (only the header line of a compound statement — a directive
    must not blanket a whole `def`/`for` body).
    """
    allow: dict = field(default_factory=dict)        # line -> set(rules)

    @classmethod
    def scan(cls, source: str,
             tree: Optional[ast.AST] = None) -> "Suppressions":
        directives = []                              # (line, rules|None)
        for i, text in enumerate(source.splitlines(), start=1):
            m = _ALLOW_RE.search(text)
            if not m:
                continue
            rules = None
            if m.group("sync"):
                rules = set(HOST_SYNC_RULES)
            if m.group("rules"):
                rules = (rules or set()) | {
                    r.strip() for r in m.group("rules").split(",")}
            if rules:
                directives.append((i, rules))

        # line extents of every SIMPLE statement (no nested body)
        spans = []
        if tree is not None and directives:
            for node in ast.walk(tree):
                if isinstance(node, ast.stmt) and not hasattr(node, "body"):
                    spans.append((node.lineno, node.end_lineno or node.lineno))
            spans.sort()

        lines = source.splitlines()

        def _is_commentary(ln: int) -> bool:
            text = lines[ln - 1].strip() if ln - 1 < len(lines) else ""
            return not text or text.startswith("#")

        sup = cls()
        for line, rules in directives:
            covered = {line, line + 1}
            enclosing = [s for s in spans if s[0] <= line <= s[1]]
            if enclosing:                # inline within a statement
                lo, hi = max(enclosing, key=lambda s: s[0])
                covered.update(range(lo, hi + 1))
            else:                        # comment line: cover the next
                below = [s for s in spans if s[0] > line]  # statement,
                if below:                # bridging further comment lines
                    lo, hi = min(below)
                    if all(_is_commentary(ln) for ln in range(line + 1, lo)):
                        covered.update(range(lo, hi + 1))
            for ln in covered:
                sup.allow.setdefault(ln, set()).update(rules)
        return sup

    def suppresses(self, finding: Finding) -> bool:
        return finding.rule in self.allow.get(finding.line, ())


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of a call target ('torch.cuda.synchronize',
    'np.random.choice', ...); '' when it is not a plain name chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_trivial_cast_arg(node: ast.AST) -> bool:
    """Arguments to float()/int() that are not device syncs: literals,
    len()-like calls, static shape metadata (``x.size``, ``x.ndim``,
    ``x.shape[i]``, ``np.shape(x)[i]`` are Python ints even on CUDA
    tensors), and numpy-namespace results (``np.mean(...)`` returns a
    host value — if a device value crossed into numpy, the sync
    happened at the ``np.asarray`` boundary the fetch rule flags).
    Bare names stay flagged: ``float(loss)`` is the sync itself."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Attribute) and node.attr in ("size", "ndim",
                                                         "n", "round"):
        return True
    if isinstance(node, ast.Subscript):
        v = node.value
        if isinstance(v, ast.Attribute) and v.attr == "shape":
            return True
        if isinstance(v, ast.Call) and _dotted(v.func) == "np.shape":
            return True
        return False
    if isinstance(node, ast.Call):
        name = _dotted(node.func)
        return (name in {"len", "min", "max", "round", "abs", "sum", "ord",
                         "bool", "time.time", "time.perf_counter"}
                or name.startswith(("np.", "numpy.", "math.")))
    if isinstance(node, (ast.Name,)):
        return False
    if isinstance(node, (ast.BinOp,)):
        return (_is_trivial_cast_arg(node.left)
                and _is_trivial_cast_arg(node.right))
    if isinstance(node, ast.UnaryOp):
        return _is_trivial_cast_arg(node.operand)
    return False


class _Scope:
    def __init__(self, node, hot: bool, cached: bool):
        self.node = node
        self.hot = hot
        self.cached = cached


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str, source: str):
        self.path = path
        self.lines = source.splitlines()
        self.findings: List[Finding] = []
        self.scopes: List[_Scope] = []

    # -- helpers -----------------------------------------------------------

    def _code(self, node) -> str:
        try:
            return self.lines[node.lineno - 1].strip()
        except IndexError:                       # pragma: no cover
            return ""

    def _emit(self, node, rule: str, message: str) -> None:
        self.findings.append(Finding(
            path=self.path, line=node.lineno, col=node.col_offset,
            rule=rule, message=message, code=self._code(node)))

    @property
    def _in_function(self) -> bool:
        return bool(self.scopes)

    @property
    def _hot(self) -> bool:
        return bool(self.scopes) and self.scopes[-1].hot

    @property
    def _cached(self) -> bool:
        return any(s.cached for s in self.scopes)

    # -- scope tracking ----------------------------------------------------

    def _visit_def(self, node) -> None:
        hot = bool(HOT_NAME_RE.match(node.name)) or self._hot
        cached = any(
            _dotted(d.func if isinstance(d, ast.Call) else d)
            in CACHING_DECORATORS
            for d in node.decorator_list)
        self.scopes.append(_Scope(node, hot, cached))
        self.generic_visit(node)
        self.scopes.pop()

    visit_FunctionDef = _visit_def
    visit_AsyncFunctionDef = _visit_def

    # -- purity ------------------------------------------------------------

    def visit_Global(self, node: ast.Global) -> None:
        self._emit(node, "purity-global-mutation",
                   f"function rebinds module global(s) "
                   f"{', '.join(node.names)}")
        self.generic_visit(node)

    # -- calls carry almost every rule --------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted(node.func)
        method = (node.func.attr if isinstance(node.func, ast.Attribute)
                  and not isinstance(node.func.value, ast.Constant) else "")
        has_generator = any(kw.arg == "generator" for kw in node.keywords)

        # host-sync rules fire only inside hot scopes
        if self._hot:
            scope = self.scopes[-1].node.name
            if name in ("float", "int") and node.args and \
                    not _is_trivial_cast_arg(node.args[0]):
                self._emit(node, "host-sync-cast",
                           f"{name}() on a non-trivial expression in hot "
                           f"scope '{scope}' — a device sync if the value "
                           f"is a CUDA tensor")
            elif name in FETCH_CALLS or method in FETCH_METHODS:
                self._emit(node, "host-sync-fetch",
                           f"device fetch '{name or method}' in hot scope "
                           f"'{scope}' outside a sanctioned fetch point")
            if name in FRESH_ARRAY_CTORS:
                self._emit(node, "retrace-fresh-array",
                           f"'{name}' builds a fresh tensor every call of "
                           f"hot scope '{scope}'")
            if name in ("torch.Generator", "Generator"):
                self._emit(node, "purity-fresh-prngkey",
                           f"fresh torch.Generator made inside hot scope "
                           f"'{scope}'")

        # retrace hazards fire in ANY uncached function scope
        if self._in_function and not self._cached and name in RETRACE_CTORS:
            self._emit(node, "retrace-ctor",
                       f"'{name}' constructed inside "
                       f"'{self.scopes[-1].node.name}' — cache it at "
                       f"module scope or behind functools.lru_cache")

        # process-global numpy and torch RNGs: anywhere, any scope
        if name.startswith(("np.random.", "numpy.random.")) and \
                name.rsplit(".", 1)[-1] not in ("RandomState",
                                                "default_rng",
                                                "Generator", "SeedSequence"):
            self._emit(node, "purity-np-random",
                       f"process-global numpy RNG call '{name}'")
        elif name in TORCH_GLOBAL_SEED or name in TORCH_LIKE_SAMPLERS or (
                (name in TORCH_SAMPLERS or method in INPLACE_SAMPLERS)
                and not has_generator):
            self._emit(node, "purity-np-random",
                       f"process-global torch RNG call '{name or method}'")

        self.generic_visit(node)


def lint_source(path: str, source: str) -> List[Finding]:
    """All findings for one file, suppression comments applied."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(path=path, line=e.lineno or 1, col=e.offset or 0,
                        rule="parse-error", message=str(e.msg), code="")]
    visitor = _Visitor(path, source)
    visitor.visit(tree)
    sup = Suppressions.scan(source, tree)
    return [f for f in visitor.findings if not sup.suppresses(f)]


def iter_python_files(targets: Iterable[str]) -> Iterable[str]:
    for target in targets:
        if os.path.isfile(target):
            yield target
            continue
        for root, dirs, files in os.walk(target):
            dirs[:] = sorted(d for d in dirs
                             if d not in ("__pycache__", ".git", "results"))
            for f in sorted(files):
                if f.endswith(".py"):
                    yield os.path.join(root, f)


def lint_paths(targets: Iterable[str]) -> List[Finding]:
    findings: List[Finding] = []
    for path in iter_python_files(targets):
        with open(path, "r", encoding="utf-8") as fh:
            findings.extend(lint_source(os.path.normpath(path), fh.read()))
    return findings


# --------------------------------------------------------------------------
# baseline: accepted pre-existing findings, fingerprinted without line
# numbers so unrelated edits never invalidate them
# --------------------------------------------------------------------------

def baseline_counts(findings: Iterable[Finding]) -> Counter:
    return Counter(f.fingerprint() for f in findings)


def save_baseline(findings: Iterable[Finding], path: str) -> None:
    counts = baseline_counts(findings)
    payload = {
        "comment": "accepted pre-existing findings; refresh with "
                   "`python -m repro_torch.analysis.lint <targets> "
                   "--write-baseline` and review the diff",
        "findings": [{"fingerprint": fp, "count": n}
                     for fp, n in sorted(counts.items())],
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=1)
        fh.write("\n")


def load_baseline(path: str) -> Counter:
    with open(path, "r", encoding="utf-8") as fh:
        payload = json.load(fh)
    return Counter({e["fingerprint"]: int(e["count"])
                    for e in payload.get("findings", [])})


def apply_baseline(findings: List[Finding],
                   baseline: Counter) -> List[Finding]:
    """Findings beyond the baselined count per fingerprint. The first
    `count` occurrences of each fingerprint are accepted; extras (new
    code repeating an old pattern) are reported."""
    remaining = Counter(baseline)
    fresh = []
    for f in findings:
        fp = f.fingerprint()
        if remaining[fp] > 0:
            remaining[fp] -= 1
        else:
            fresh.append(f)
    return fresh


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Trace-hygiene linter for the port "
                    "(host syncs, retrace hazards, purity).")
    ap.add_argument("targets", nargs="+",
                    help="files or directories to lint")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help=f"baseline JSON (default {DEFAULT_BASELINE}; "
                         f"ignored when missing unless --strict-baseline)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept all current findings into the baseline "
                         "and exit 0")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring any baseline")
    ap.add_argument("--strict-baseline", action="store_true",
                    help="error if the baseline file is missing")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--rules", default=None,
                    help="comma list restricting reported rule ids")
    args = ap.parse_args(argv)

    findings = lint_paths(args.targets)
    if args.rules:
        keep = {r.strip() for r in args.rules.split(",")}
        findings = [f for f in findings if f.rule in keep]

    if args.write_baseline:
        save_baseline(findings, args.baseline)
        print(f"wrote {len(findings)} finding(s) to {args.baseline}")
        return 0

    if not args.no_baseline and os.path.exists(args.baseline):
        findings = apply_baseline(findings, load_baseline(args.baseline))
    elif args.strict_baseline and not args.no_baseline:
        print(f"baseline {args.baseline} not found", file=sys.stderr)
        return 2

    if args.format == "json":
        print(json.dumps([f.__dict__ for f in findings], indent=1))
    else:
        for f in findings:
            print(f.format())
        by_rule = Counter(f.rule for f in findings)
        summary = ", ".join(f"{r}={n}" for r, n in sorted(by_rule.items()))
        print(f"{len(findings)} finding(s)"
              + (f" [{summary}]" if findings else ""))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
