"""The port's analysis layer (repro_torch.analysis lint and contracts)
against the reference's (repro.analysis).

Three parts:

  lint       tests/test_analysis.py's lint cases translated to torch, with
             the same rule ids and counts at the same lines (a jax
             trigger replaced by its torch counterpart on the same line);
             the reference's own snippets for the language-neutral rules
             (casts, ``.item()``, ``np.asarray``, ``global``,
             ``np.random``, the suppressions) through both linters, the
             same (line, rule) sets and fingerprints; baselines written
             by one linter read by the other; the port's tree at 0
             findings against its own baseline.
  contracts  tests/test_analysis.py's contract cases over the port's
             registries and broken entries, the same rule ids; and
             registry parity: the same entry names in both packages, and
             each entry's fake-tensor output shapes and dtypes against the
             reference's `jax.eval_shape` outputs.

The guards (repro_torch.analysis.guards) are tested in
tests/test_torch_guards.py, which imports no jax, so that its card cases
run on a machine without it.

Everything is abstract (fake tensors, `jax.eval_shape`) or stdlib, so
nothing trains; about 40 s in one process, most of it the two packages'
client-step traces.
"""
from __future__ import annotations

import json
import os
import textwrap
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.analysis import contracts as jcontracts
from repro.analysis import lint as jlint
from repro_torch.analysis import contracts, lint
from repro_torch.comms import codecs as codecs_mod
from repro_torch.comms.codecs import Codec
from repro_torch.convert import flat_spec, leaves_with_paths, ravel, unravel
from repro_torch.core.cohort import CohortBatch
from test_torch_round import torch_threads  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rules(findings):
    return Counter(f.rule for f in findings)


def _lint(snippet):
    return lint.lint_source("snippet.py", textwrap.dedent(snippet))


# --------------------------------------------------------------------------
# lint: seeded violations, one block per rule class
# --------------------------------------------------------------------------

def test_lint_flags_host_syncs_in_hot_scope():
    findings = _lint("""\
        import torch
        import numpy as np

        def run_round(state, losses, x):
            a = float(losses[0])
            b = int(x.mean())
            c = losses.cpu()
            torch.cuda.synchronize()
            d = losses.item()
            e = np.asarray(x)
            return a, b, c, d, e
    """)
    by_rule = _rules(findings)
    assert by_rule["host-sync-cast"] == 2
    assert by_rule["host-sync-fetch"] == 4
    assert sum(by_rule[r] for r in lint.HOST_SYNC_RULES) >= 5
    # findings carry location + a fix hint
    f = findings[0]
    assert f.path == "snippet.py" and f.line == 5 and f.hint
    assert [(g.line, g.rule) for g in findings if g.rule ==
            "host-sync-fetch"] == [(7, "host-sync-fetch"),
                                   (8, "host-sync-fetch"),
                                   (9, "host-sync-fetch"),
                                   (10, "host-sync-fetch")]


def test_lint_flags_torch_fetches_in_the_port_hot_scopes():
    """The port's own fetch triggers (``.tolist()``, ``.numpy()``, a
    stream's or an event's ``.synchronize()``, ``np.array``), in the
    port's own hot names (the engine's replay, the batched client step)."""
    findings = _lint("""\
        import numpy as np
        import torch

        def replay(self, xs, stream, event):
            a = xs.tolist()
            b = xs.numpy()
            stream.synchronize()
            event.synchronize()
            return a, b, np.array(xs)

        def train_chunks(cfg, tree, images):
            return images.cpu()

        def helper(xs):
            return xs.tolist(), xs.cpu()
    """)
    assert [(f.line, f.rule) for f in findings] == [
        (5, "host-sync-fetch"), (6, "host-sync-fetch"),
        (7, "host-sync-fetch"), (8, "host-sync-fetch"),
        (9, "host-sync-fetch"), (12, "host-sync-fetch")]


def test_lint_host_syncs_quiet_outside_hot_scope():
    """The same syncs in a cold helper are fine — hotness is scoped."""
    findings = _lint("""\
        import torch

        def summarize(losses, x):
            return float(losses[0]), x.cpu()
    """)
    assert not findings


def test_lint_trivial_casts_not_flagged():
    """Shape metadata and host-side math are not device syncs."""
    findings = _lint("""\
        def run_round(x, cfg):
            a = int(x.shape[0])
            b = float(x.size)
            c = int(len(x))
            d = float(x.ndim + 1)
            return a, b, c, d
    """)
    assert not [f for f in findings if f.rule == "host-sync-cast"]


def test_lint_flags_retrace_hazards():
    findings = _lint("""\
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        def run_campaign(sc, spec):
            mesh = init_device_mesh("cuda", (2,))
            group = dist.new_group([0, 1])
            graph = torch.cuda.CUDAGraph()
            w = torch.tensor([0.25, 0.75])
            z = torch.full((4,), 0.5)
            return mesh, group, graph, w, z
    """)
    by_rule = _rules(findings)
    assert by_rule["retrace-ctor"] == 3        # mesh, group, graph
    # no jit cache keyed on static arguments in the port: cannot fire
    assert by_rule["retrace-static-unhashable"] == 0
    assert by_rule["retrace-fresh-array"] == 2
    assert sum(by_rule.values()) >= 5
    assert [(f.line, f.rule) for f in findings] == [
        (6, "retrace-ctor"), (7, "retrace-ctor"), (8, "retrace-ctor"),
        (9, "retrace-fresh-array"), (10, "retrace-fresh-array")]
    more = _lint("""\
        import ctypes
        import torch

        def load(path, fn):
            lib = ctypes.CDLL(path)
            with torch.cuda.graph(torch.cuda.CUDAGraph()):
                pass
            return lib, torch.compile(fn)
    """)
    assert _rules(more) == {"retrace-ctor": 4}


def test_lint_retrace_quiet_under_lru_cache():
    """lru_cache'd construction is the sanctioned pattern, not a hazard."""
    findings = _lint("""\
        import functools
        from torch.distributed.device_mesh import init_device_mesh

        @functools.lru_cache(maxsize=None)
        def cohort_mesh(n):
            return init_device_mesh("cuda", (n,))
    """)
    assert not [f for f in findings if f.rule == "retrace-ctor"]


def test_lint_flags_purity_violations():
    findings = _lint("""\
        import torch
        import numpy as np

        _CACHE = None

        def finalize(tree):
            global _CACHE
            gen = torch.Generator()
            ids = np.random.permutation(8)
            np.random.seed(0)
            v = np.random.rand(3)
            return gen, ids, v
    """)
    by_rule = _rules(findings)
    assert by_rule["purity-global-mutation"] == 1
    assert by_rule["purity-fresh-prngkey"] == 1
    assert by_rule["purity-np-random"] == 3
    assert sum(by_rule.values()) >= 5
    # the packed-RandomState discipline is NOT flagged
    ok = _lint("""\
        import numpy as np

        def plan_round(host_rng):
            rs = np.random.RandomState(0)
            return rs.permutation(8)
    """)
    assert not [f for f in ok if f.rule == "purity-np-random"]


def test_lint_flags_the_global_torch_rng():
    """Seeding, the samplers without ``generator=``, the ``*_like``
    samplers and the in-place samplers; draws from a passed generator are
    the port's rule and pass."""
    findings = _lint("""\
        import torch

        def plan(x, gen):
            torch.manual_seed(0)
            torch.cuda.manual_seed_all(0)
            a = torch.rand(3)
            b = torch.randn(3, generator=gen)
            c = torch.randperm(8)
            d = torch.rand_like(x)
            x.uniform_()
            x.normal_(generator=gen)
            e = torch.bernoulli(x, generator=gen)
            f = torch.multinomial(x, 2)
            return a, b, c, d, e, f
    """)
    assert [(f.line, f.rule) for f in findings] == [
        (4, "purity-np-random"), (5, "purity-np-random"),
        (6, "purity-np-random"), (8, "purity-np-random"),
        (9, "purity-np-random"), (10, "purity-np-random"),
        (13, "purity-np-random")]


# --------------------------------------------------------------------------
# lint: suppression + baseline mechanics
# --------------------------------------------------------------------------

def test_suppression_inline_and_preceding_comment():
    findings = _lint("""\
        def run_round(losses, velocities, lr):
            a = float(losses[0])  # analysis: allow=host-sync-cast -- once/round
            # analysis: sanctioned-sync -- the designed per-round fetch
            b = (velocities.cpu(),
                 float(lr))
            return a, b
    """)
    assert not findings


def test_suppression_is_rule_specific():
    """allow= names exact rules; other rules on the line still fire."""
    findings = _lint("""\
        import torch

        def run_round(x):
            w = float(torch.as_tensor(x).sum())  # analysis: allow=host-sync-cast
            return w
    """)
    assert _rules(findings) == {"retrace-fresh-array": 1}


def test_suppression_does_not_blanket_compound_bodies():
    """A comment directive covers the NEXT simple statement, not a whole
    loop body below it."""
    findings = _lint("""\
        def run_round(losses):
            # analysis: sanctioned-sync -- only the first line below
            for i in range(3):
                a = float(losses[i])
            return a
    """)
    assert _rules(findings) == {"host-sync-cast": 1}


def test_baseline_accepts_first_n_then_reports_extras(tmp_path):
    snippet = """\
        def run_round(losses):
            return float(losses[0])
    """
    old = _lint(snippet)
    path = str(tmp_path / "baseline.json")
    lint.save_baseline(old, path)
    baseline = lint.load_baseline(path)
    # unchanged code: fully absorbed
    assert lint.apply_baseline(_lint(snippet), baseline) == []
    # a new finding with a new fingerprint survives the baseline
    grown = _lint("""\
        def run_round(losses):
            return float(losses[0]), float(losses[1])
    """)
    fresh = lint.apply_baseline(grown, baseline)
    # the reworked line is a NEW fingerprint: both casts on it report
    assert len(fresh) == 2 and all(
        f.code == "return float(losses[0]), float(losses[1])" for f in fresh)
    # fingerprints are line-number free: shifting the finding is a no-op
    shifted = _lint("""\
        import os

        def run_round(losses):
            return float(losses[0])
    """)
    assert lint.apply_baseline(shifted, baseline) == []


def test_lint_cli_zero_against_committed_baseline(capsys, monkeypatch):
    """The port's tree lints clean against its own baseline,
    src/repro_torch/analysis/baseline.json."""
    monkeypatch.chdir(ROOT)
    rc = lint.main([os.path.join("src", "repro_torch"), "--strict-baseline"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "0 finding(s)" in out
    assert lint.load_baseline(lint.DEFAULT_BASELINE) == Counter()


def test_lint_cli_flags_and_summary(tmp_path, capsys):
    """--no-baseline, --rules, --format json, --write-baseline and the
    summary line, as in the reference's CLI."""
    src = tmp_path / "m.py"
    src.write_text(textwrap.dedent("""\
        import torch

        def run_round(x):
            return x.item(), torch.zeros(3)
    """))
    base = str(tmp_path / "b.json")
    assert lint.main([str(src), "--baseline", base]) == 1
    assert capsys.readouterr().out.splitlines()[-1] == (
        "2 finding(s) [host-sync-fetch=1, retrace-fresh-array=1]")
    assert lint.main([str(src), "--baseline", base, "--strict-baseline"]) == 2
    capsys.readouterr()
    assert lint.main([str(src), "--rules", "host-sync-fetch",
                      "--format", "json", "--baseline", base]) == 1
    got = json.loads(capsys.readouterr().out)
    assert [f["rule"] for f in got] == ["host-sync-fetch"]
    assert lint.main([str(src), "--baseline", base,
                      "--write-baseline"]) == 0
    capsys.readouterr()
    assert lint.main([str(src), "--baseline", base]) == 0
    assert capsys.readouterr().out.strip() == "0 finding(s)"
    assert lint.main([str(src), "--baseline", base, "--no-baseline"]) == 1


# --------------------------------------------------------------------------
# lint parity: the reference's snippets through both linters
# --------------------------------------------------------------------------

# tests/test_analysis.py's snippets for the language-neutral rules; a
# jax-only line (jax.device_get, block_until_ready, PRNGKey, jnp.asarray)
# is replaced by a neutral one on the same line, so line numbers hold
NEUTRAL_SNIPPETS = {
    "host-syncs": """\
        import jax
        import numpy as np

        def run_round(state, losses, x):
            a = float(losses[0])
            b = int(x.mean())
            c = losses
            x = x
            d = losses.item()
            e = np.asarray(x)
            return a, b, c, d, e
    """,
    "cold-scope": """\
        import numpy as np

        def summarize(losses, x):
            return float(losses[0]), np.asarray(x), x.item()
    """,
    "trivial-casts": """\
        def run_round(x, cfg):
            a = int(x.shape[0])
            b = float(x.size)
            c = int(len(x))
            d = float(x.ndim + 1)
            return a, b, c, d
    """,
    "purity": """\
        import jax
        import numpy as np

        _CACHE = None

        def finalize(tree):
            global _CACHE
            key = 0
            ids = np.random.permutation(8)
            np.random.seed(0)
            v = np.random.rand(3)
            return key, ids, v
    """,
    "purity-ok": """\
        import numpy as np

        def plan_round(host_rng):
            rs = np.random.RandomState(0)
            return rs.permutation(8)
    """,
    "suppression-inline": """\
        def run_round(losses, velocities, lr):
            a = float(losses[0])  # analysis: allow=host-sync-cast -- once/round
            # analysis: sanctioned-sync -- the designed per-round fetch
            b = (velocities.item(),
                 float(lr))
            return a, b
    """,
    "suppression-rule-specific": """\
        import numpy as np

        def run_round(x):
            w = float(np.asarray(x).sum())  # analysis: allow=host-sync-cast
            return w
    """,
    "suppression-no-blanket": """\
        def run_round(losses):
            # analysis: sanctioned-sync -- only the first line below
            for i in range(3):
                a = float(losses[i])
            return a
    """,
    "baseline-grown": """\
        def run_round(losses):
            return float(losses[0]), float(losses[1])
    """,
}


@pytest.mark.parametrize("case", sorted(NEUTRAL_SNIPPETS))
def test_lint_parity_with_the_reference(case):
    src = textwrap.dedent(NEUTRAL_SNIPPETS[case])
    mine = lint.lint_source("snippet.py", src)
    ref = jlint.lint_source("snippet.py", src)
    assert {(f.line, f.rule) for f in mine} == \
        {(f.line, f.rule) for f in ref}
    assert sorted(f.fingerprint() for f in mine) == \
        sorted(f.fingerprint() for f in ref)


def test_baselines_cross_the_two_linters(tmp_path):
    """A baseline one linter writes absorbs the other's findings of the
    same code, both ways."""
    src = textwrap.dedent(NEUTRAL_SNIPPETS["host-syncs"])
    mine = lint.lint_source("snippet.py", src)
    ref = jlint.lint_source("snippet.py", src)
    assert mine
    lint.save_baseline(mine, str(tmp_path / "mine.json"))
    jlint.save_baseline(ref, str(tmp_path / "ref.json"))
    assert jlint.apply_baseline(
        ref, jlint.load_baseline(str(tmp_path / "mine.json"))) == []
    assert lint.apply_baseline(
        mine, lint.load_baseline(str(tmp_path / "ref.json"))) == []


def test_the_port_tree_is_clean_under_both_linters():
    """Every mark added to the port serves both linters: the port's tree
    has no unsuppressed finding under either rule set."""
    tree = os.path.join(ROOT, "src", "repro_torch")
    assert lint.lint_paths([tree]) == []
    assert jlint.lint_paths([tree]) == []


# --------------------------------------------------------------------------
# contracts: the real registries check clean
# --------------------------------------------------------------------------

def test_real_registries_pass_contracts():
    violations = contracts.check_all()
    assert violations == [], "\n".join(map(str, violations))


def test_contracts_cli_counts_equal_the_reference(capsys):
    assert contracts.main([]) == 0
    mine = capsys.readouterr().out.strip()
    assert mine == ("contracts: 18 registry entries OK (SCHEME_WEIGHTS=5, "
                    "AGGREGATORS=5, CLIENT_UPDATES=2, TOPOLOGIES=3, "
                    "CODECS=3)")
    from repro.comms import codecs as jcodecs
    from repro.core import aggregation as jagg
    from repro.core import clients as jclients
    from repro.core import topology as jtopo
    assert mine.endswith(
        f"(SCHEME_WEIGHTS={len(jagg.SCHEME_WEIGHTS)}, "
        f"AGGREGATORS={len(jagg.AGGREGATORS)}, "
        f"CLIENT_UPDATES={len(jclients.CLIENT_UPDATES)}, "
        f"TOPOLOGIES={len(jtopo.TOPOLOGIES)}, "
        f"CODECS={len(jcodecs.CODECS)})")


# --------------------------------------------------------------------------
# contracts: broken aggregators -> contract-treedef
# --------------------------------------------------------------------------

def _good_agg(cohort, cfg):
    from repro_torch.core.aggregation import cohort_weighted_sum
    w = cohort.mask[:cohort.n] / torch.clamp(cohort.mask.sum(), min=1.0)
    return cohort_weighted_sum(cohort, w)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


BROKEN_AGGREGATORS = {
    "wrapped-structure": lambda c, cfg: {"tree": _good_agg(c, cfg)},
    "reduced-shape": lambda c, cfg: _tree_map(
        lambda leaf: leaf.sum(dim=-1), _good_agg(c, cfg)),
    "cast-dtype": lambda c, cfg: _tree_map(
        lambda leaf: leaf.to(torch.float16), _good_agg(c, cfg)),
    # the cohort's rows unraveled: every leaf keeps its cohort axis
    "stacked-passthrough": lambda c, cfg: unravel(c.flat, c.spec),
    "scalar": lambda c, cfg: torch.zeros(()),
}


def test_broken_aggregators_flagged_with_treedef_rule():
    violations = contracts.check_aggregators(BROKEN_AGGREGATORS)
    assert len(violations) == len(BROKEN_AGGREGATORS) >= 5
    assert {v.entry for v in violations} == set(BROKEN_AGGREGATORS)
    assert all(v.rule == contracts.RULE_TREEDEF for v in violations)
    assert all(v.registry == "AGGREGATORS" for v in violations)
    # and the sane reference passes
    assert contracts.check_aggregators({"good": _good_agg}) == []


# --------------------------------------------------------------------------
# contracts: broken client updates -> contract-mask
# --------------------------------------------------------------------------

class _FakeClient:
    """Minimal CLIENT_UPDATES-shaped entry: echoes the global tree per
    row. `variant` seeds one specific contract violation."""

    def __init__(self, variant="good"):
        self.variant = variant

    def init_state(self, cfg, tree):
        return None

    def run_cohort(self, cfg, tree, client_state, batches, draws, lr,
                   parallel=True, pad_to=None, mesh=None):
        n = len(batches)
        flat = ravel(tree)[None].expand(n, -1)
        vec = torch.zeros((n,), dtype=torch.float32)
        mask = torch.ones((n,), dtype=torch.float32)
        v = self.variant
        if v == "plain-tree":
            return _tree_map(lambda leaf: leaf[None].expand(
                n, *leaf.shape), tree), None   # no CohortBatch at all
        if v == "mask-none":
            mask = None
        elif v == "mask-shape":
            mask = torch.ones((n + 1,), dtype=torch.float32)
        elif v == "mask-dtype":
            mask = torch.ones((n,), dtype=torch.int32)
        count = n - 1 if v == "wrong-n" else n
        return CohortBatch(flat=flat, spec=flat_spec(tree), losses=vec,
                           mask=mask, n=count, velocities=vec,
                           blur=vec), None


BROKEN_CLIENTS = ("plain-tree", "mask-none", "mask-shape", "mask-dtype",
                  "wrong-n")


def test_broken_client_updates_flagged_with_mask_rule():
    broken = {v: _FakeClient(v) for v in BROKEN_CLIENTS}
    violations = contracts.check_client_updates(broken)
    assert len(BROKEN_CLIENTS) >= 5
    by_entry = {v.entry: v for v in violations}
    assert set(by_entry) == set(BROKEN_CLIENTS)
    assert all(v.rule == contracts.RULE_MASK for v in violations)
    assert all(v.registry == "CLIENT_UPDATES" for v in violations)
    # the well-formed variant passes the same checker
    assert contracts.check_client_updates({"good": _FakeClient()}) == []


# --------------------------------------------------------------------------
# contracts: broken weighting schemes -> contract-weight-*
# --------------------------------------------------------------------------

def test_scheme_weight_dtype_mismatch_flagged():
    violations = contracts.check_scheme_weights(
        {"int-weights": lambda c, cfg: torch.ones((c.n,), dtype=torch.int32)})
    assert [v.rule for v in violations] == [contracts.RULE_WEIGHT_DTYPE]


def test_scheme_padded_row_leak_flagged_with_hint():
    """Weights over the padded axis (m,) instead of the valid prefix
    (n,): the classic CohortBatch bug, flagged with a targeted hint."""
    violations = contracts.check_scheme_weights(
        {"padded": lambda c, cfg: c.mask / c.mask.sum()})
    assert violations and violations[0].rule == contracts.RULE_WEIGHT_SHAPE
    assert "padded rows" in violations[0].message


# --------------------------------------------------------------------------
# contracts: broken comms codecs -> contract-codec
# --------------------------------------------------------------------------

def _fake_codec(**over):
    kw = dict(name="fake", lossless=True, stateful=False,
              encode=lambda rows, base, ef=None: ({"trees": rows}, None),
              decode=lambda p, base: p["trees"],
              init_state=lambda cfg, tree: None)
    kw.update(over)
    return Codec(**kw)


BROKEN_CODECS = {
    # decode loses the dtype: aggregation would run on f16 rows
    "cast-dtype": _fake_codec(decode=lambda p, base:
                              p["trees"].to(torch.float16)),
    # decode collapses the cohort axis
    "row-collapse": _fake_codec(decode=lambda p, base: p["trees"][:1]),
    # a stateless codec smuggling cross-round state out of encode
    "stateless-ef": _fake_codec(encode=lambda rows, base, ef=None:
                                ({"trees": rows}, torch.zeros((1, 8)))),
    # a stateful codec that shrinks the residual it was handed
    "ef-shrink": _fake_codec(
        stateful=True,
        init_state=lambda cfg, tree: {"ef": torch.zeros(
            (cfg.vehicles_per_round, 256), dtype=torch.float32)},
        encode=lambda rows, base, ef=None: ({"trees": rows}, ef[:1])),
}


def test_broken_codecs_flagged_with_codec_rule():
    violations = contracts.check_codecs(BROKEN_CODECS)
    by_entry = {v.entry: v for v in violations}
    assert set(by_entry) == set(BROKEN_CODECS)
    assert all(v.rule == contracts.RULE_CODEC for v in violations)
    assert all(v.registry == "CODECS" for v in violations)
    # and the well-formed passthrough passes the same checker
    assert contracts.check_codecs({"good": _fake_codec()}) == []


BROKEN_SERVE_CODECS = {
    # decode strips the snapshot's row axis: a vehicle would unravel the
    # wrong row
    "axis-collapse": _fake_codec(decode=lambda p, base: p["trees"][0]),
    # encode yields nothing to put on the wire; decode re-grows the row
    # from the base so the roundtrip alone would look fine
    "empty-payload": _fake_codec(
        encode=lambda rows, base, ef=None: ({}, None),
        decode=lambda p, base: base[None]),
}


def test_broken_snapshot_framing_flagged_with_serve_rule():
    violations = contracts.check_serve(BROKEN_SERVE_CODECS)
    by_entry = {v.entry: v for v in violations}
    assert set(by_entry) == set(BROKEN_SERVE_CODECS)
    assert all(v.rule == contracts.RULE_SERVE for v in violations)
    assert all(v.registry == "CODECS" for v in violations)
    # the well-formed passthrough frames snapshots correctly
    assert contracts.check_serve({"good": _fake_codec()}) == []


def test_real_codecs_pass_serve_contract():
    assert contracts.check_serve() == []


def test_scheme_crash_reported_not_raised():
    violations = contracts.check_scheme_weights(
        {"boom": lambda c, cfg: (_ for _ in ()).throw(ValueError("boom"))})
    assert [v.rule for v in violations] == [contracts.RULE_EVAL_ERROR]


def test_data_dependent_entry_reported_as_eval_error():
    """An entry that reads data (``.item()``) raises over fake tensors:
    reported as contract-eval-error, not swallowed."""
    violations = contracts.check_scheme_weights(
        {"reads": lambda c, cfg: torch.full((c.n,), c.blur.sum().item())})
    assert [v.rule for v in violations] == [contracts.RULE_EVAL_ERROR]


# --------------------------------------------------------------------------
# contracts: topology registry API
# --------------------------------------------------------------------------

def test_topology_api_violations_flagged():
    class NoSignature:
        name = "nosig"

        def init_topo_state(self, scenario):
            return {}

        def plan_round(self, state, scenario, rng):
            return {}

    violations = contracts.check_topologies({"nosig": NoSignature})
    assert violations
    assert all(v.rule == contracts.RULE_TOPOLOGY_API for v in violations)


# --------------------------------------------------------------------------
# registry parity: the same entries, the same abstract outputs
# --------------------------------------------------------------------------

def _jax_paths(tree) -> dict:
    """{path tuple: (shape, dtype name)} of a jax pytree of SDS."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(k.key for k in path): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in flat}


def _torch_paths(tree) -> dict:
    return {path: (tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""))
            for path, leaf in leaves_with_paths(tree)}


def _nbytes(shapes: dict) -> int:
    return sum(int(np.prod(s)) * np.dtype(d).itemsize
               for s, d in shapes.values())


REGISTRIES = (("SCHEME_WEIGHTS", "repro.core.aggregation",
               "repro_torch.core.aggregation"),
              ("AGGREGATORS", "repro.core.aggregation",
               "repro_torch.core.aggregation"),
              ("CLIENT_UPDATES", "repro.core.clients",
               "repro_torch.core.clients"),
              ("TOPOLOGIES", "repro.core.topology", "repro_torch.core.topology"),
              ("CODECS", "repro.comms.codecs", "repro_torch.comms.codecs"))


@pytest.mark.parametrize("registry,ref_mod,port_mod", REGISTRIES)
def test_registries_hold_the_same_entries(registry, ref_mod, port_mod):
    import importlib
    ref = getattr(importlib.import_module(ref_mod), registry)
    port = getattr(importlib.import_module(port_mod), registry)
    assert sorted(port) == sorted(ref)


@pytest.fixture(scope="module")
def jtree():
    return jcontracts.model_tree_sds()


def test_model_tree_is_the_reference_tree(jtree):
    with FakeTensorMode():
        mine = _torch_paths(contracts.model_tree_fake())
    assert mine == _jax_paths(jtree)
    assert _nbytes(mine) == 4 * 11_506_624


def test_scheme_weights_and_aggregators_match_eval_shape(jtree):
    """Each scheme's weights and each aggregator's tree, at both
    geometries, shape and dtype for shape and dtype the reference's."""
    from repro.core import aggregation as jagg
    from repro_torch.core import aggregation as agg
    cfg, jcfg = contracts._check_cfg(), jcontracts._check_cfg()
    for n, m in contracts._GEOMETRIES:
        jcoh = jcontracts.abstract_cohort(jtree, n, m)
        with FakeTensorMode():
            coh = contracts.abstract_cohort(contracts.model_tree_fake(), n, m)
            for name in sorted(agg.SCHEME_WEIGHTS):
                w = agg.SCHEME_WEIGHTS[name](coh, cfg)
                jw = jax.eval_shape(
                    lambda c, f=jagg.SCHEME_WEIGHTS[name]: f(c, jcfg), jcoh)
                assert (tuple(w.shape), str(w.dtype)[6:]) == \
                    (tuple(jw.shape), str(jw.dtype)), (name, n, m)
            for name in sorted(agg.AGGREGATORS):
                tree = _torch_paths(agg.AGGREGATORS[name](coh, cfg))
                jt = jax.eval_shape(
                    lambda c, f=jagg.AGGREGATORS[name]: f(c, jcfg), jcoh)
                assert tree == _jax_paths(jt), (name, n, m)


def test_client_updates_match_eval_shape(jtree):
    """Each client update's cohort: the port's (m, P) float32 rows hold
    exactly the reference's stacked trees (m rows, the same bytes a row),
    the same mask, losses and valid count."""
    from repro.core import clients as jclients
    from repro_torch.core import clients as clients_mod
    for name in sorted(clients_mod.CLIENT_UPDATES):
        cfg = contracts._check_cfg(client=name)
        jcfg = jcontracts._check_cfg(client=name)
        n = cfg.vehicles_per_round
        entry = jclients.CLIENT_UPDATES[name]
        jstate = jax.eval_shape(lambda t: entry.init_state(jcfg, t), jtree)
        jcoh, _ = jax.eval_shape(
            lambda t, cs, b, k, lr: entry.run_cohort(jcfg, t, cs, b, k, lr,
                                                     parallel=True),
            jtree, jstate,
            jax.ShapeDtypeStruct((n, jcfg.batch_size, 4, 4, 3), jnp.float32),
            jax.ShapeDtypeStruct((n, 2), jnp.uint32),
            jax.ShapeDtypeStruct((), jnp.float32))
        stacked = _jax_paths(jcoh.trees)
        m = int(jcoh.mask.shape[0])
        with FakeTensorMode():
            tree = contracts.model_tree_fake()
            pentry = clients_mod.CLIENT_UPDATES[name]
            from repro_torch.core.topology import _pi_draws
            coh, _ = pentry.run_cohort(
                cfg, tree, pentry.init_state(cfg, tree),
                [torch.empty((cfg.batch_size, 4, 4, 3)) for _ in range(n)],
                _pi_draws(torch.Generator().manual_seed(cfg.seed), cfg, n),
                torch.empty(()), parallel=True)
            got = (tuple(coh.flat.shape), str(coh.flat.dtype),
                   tuple(coh.mask.shape), str(coh.mask.dtype),
                   tuple(coh.losses.shape), coh.n)
        assert all(s[0] == m for s, _ in stacked.values())
        assert got == ((m, _nbytes(stacked) // (4 * m)), "torch.float32",
                       (m,), "torch." + str(jcoh.mask.dtype),
                       tuple(jcoh.losses.shape), jcoh.n), name


def test_codecs_match_eval_shape(jtree):
    """Each codec at both geometries: the payload's bytes (and, for the
    int8 codec, its shapes and dtypes), the residual's shape, and the
    decoded rows, against the reference's abstract outputs."""
    from repro.comms import codecs as jcodecs
    for _, m in contracts._GEOMETRIES:
        stacked = jax.tree.map(
            lambda l: jax.ShapeDtypeStruct((m,) + tuple(l.shape), l.dtype),
            jtree)
        jcfg = jcontracts._check_cfg(vehicles_per_round=m)
        cfg = contracts._check_cfg(vehicles_per_round=m)
        for name in sorted(codecs_mod.CODECS):
            jc, c = jcodecs.CODECS[name], codecs_mod.CODECS[name]
            jstate = jax.eval_shape(lambda t: jc.init_state(jcfg, t), jtree)
            if jc.stateful:
                jpay, jef = jax.eval_shape(
                    lambda s, b, e: jc.encode(s, b, e), stacked, jtree,
                    jstate["ef"])
            else:
                jpay, jef = jax.eval_shape(lambda s, b: jc.encode(s, b),
                                           stacked, jtree)
            jdec = jax.eval_shape(lambda p, b: jc.decode(p, b), jpay, jtree)
            with FakeTensorMode():
                tree = contracts.model_tree_fake()
                base = ravel(tree)
                rows = torch.empty((m, base.shape[0]))
                state = c.init_state(cfg, tree)
                pay, ef = (c.encode(rows, base, state["ef"]) if c.stateful
                           else c.encode(rows, base))
                dec = c.decode(pay, base)
                pay_shapes = _torch_paths(pay)
                ef_shape = None if ef is None else tuple(ef.shape)
                dec_shape = (tuple(dec.shape), str(dec.dtype))
            jpay_shapes = _jax_paths(jpay)
            assert _nbytes(pay_shapes) == _nbytes(jpay_shapes), (name, m)
            if name == "delta_int8":
                assert pay_shapes == jpay_shapes
            assert ef_shape == (None if jef is None else tuple(jef.shape))
            assert dec_shape == ((m, _nbytes(_jax_paths(jdec)) // (4 * m)),
                                 "torch.float32")


def test_snapshot_framing_matches_eval_shape(jtree):
    """encode_snapshot / decode_snapshot: the identity payload leaf for
    leaf the reference's, the others byte for byte (shape for shape under
    delta_int8), and the decoded tree the reference's."""
    from repro.comms import codecs as jcodecs
    for name in sorted(codecs_mod.CODECS):
        jc = jcodecs.CODECS[name]
        jpay = jax.eval_shape(
            lambda t, b: jcodecs.encode_snapshot(jc, t, b), jtree, jtree)
        jdec = jax.eval_shape(
            lambda p, b: jcodecs.decode_snapshot(jc, p, b), jpay, jtree)
        with FakeTensorMode():
            tree = contracts.model_tree_fake()
            c = codecs_mod.CODECS[name]
            pay = codecs_mod.encode_snapshot(c, tree, tree)
            dec = _torch_paths(codecs_mod.decode_snapshot(c, pay, tree))
            pay = _torch_paths(pay)
        jpay = _jax_paths(jpay)
        assert _nbytes(pay) == _nbytes(jpay), name
        if name in ("identity", "delta_int8"):
            assert pay == jpay, name
        assert dec == _jax_paths(jdec), name
