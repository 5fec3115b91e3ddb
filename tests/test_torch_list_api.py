"""The last public functions of the reference with a port: AdamW, the
token view, the synthetic token stream and class histogram, the
list-API aggregators and the list and stacked weighted sums, the
`FederatedTrainer` shim and the cohort's tree views (`from_list`,
`from_stacked`, `valid_trees`, `unstack`, `valid_velocities`), each
against the reference on the CPU from the same inputs; and the
function-level diff of the two packages, which holds only the JAX-only
and TPU-only names, and its method-level cases, which hold none.

    PYTHONPATH=src python -m pytest tests/test_torch_list_api.py
"""
from __future__ import annotations

import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core.cohort import CohortBatch as JCohortBatch
from repro.core.federation import FederatedTrainer as JFederatedTrainer
from repro.core.state import FLConfig as JFLConfig
from repro.core import ssl as jssl
from repro.data import synthetic as jdata
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.optim import optimizers as jopt
from repro_torch import convert
from repro_torch.core import aggregation as tagg
from repro_torch.core import ssl as tssl
from repro_torch.core.cohort import CohortBatch
from repro_torch.core.federation import FederatedTrainer
from repro_torch.core.scenario import Scenario, run_round
from repro_torch.core.state import FLConfig
from repro_torch.data import synthetic as tdata
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.optim import optimizers as topt
from test_torch_round import torch_threads  # noqa: F401 (autouse)
from torch_sharded_ranks import _narrow_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# AdamW: every operation is the reference's in float32, but b ** count
# and sqrt may round differently in the two libraries (each within an
# ULP): a few float32 ULPs of the update, relative
ADAM_REL = 1e-6
# the list aggregators: the port's ascending row sum against XLA's
# tensordot, as tests/test_torch_sharded.py's REF_TOL
AGG_TOL = 1e-6

# The reference's public names the port does not define, each with why:
# the Pallas kernels and their backend switches are TPU-only (the port's
# kernels are CUDA C++ behind kernels/ops.py); the jit factories and
# caches, the ShapeDtypeStruct tree and the jax version shims (compat.py)
# are JAX-only, and so is models/scan_ctx.py (scan unrolling for XLA's
# cost analysis); launch/dryrun.py's calibrate_one extrapolates XLA's cost analysis,
# which counts a scan body once, while the port's trace runs every layer
# in a Python loop and counts them all; launch/mesh.py's axis_size is
# collectives.axis_size, imported there.
NOT_PORTED = {
    "kernels/qdelta.py": {"q8_decode_pallas", "q8_encode_pallas"},
    "kernels/wagg.py": {"wagg_pallas"},
    "kernels/dt_loss.py": {"dt_loss_fwd_pallas"},
    "kernels/rwkv6.py": {"rwkv6_pallas"},
    "comms/codecs.py": {"q8_backend", "set_q8_backend"},
    "core/aggregation.py": {"set_wagg_backend", "wagg_backend"},
    "analysis/contracts.py": {"model_tree_sds"},
    "core/clients.py": {"cohort_step_cache_size", "make_local_train_step",
                        "make_moco_local_train_step", "raw_local_step",
                        "reset_cohort_step_caches"},
    "launch/mesh.py": {"axis_size"},
    "launch/dryrun.py": {"calibrate_one"},
}
NO_PORT_MODULE = {"compat.py", "models/scan_ctx.py"}
# The public methods of a class both packages define that the port's
# class lacks (inherited methods resolved within each module): none.
NOT_PORTED_METHODS: dict = {}


def _t(x):
    return torch.from_numpy(np.array(x))


def _trees(rs, n):
    out = []
    for _ in range(n):
        t = {"params": {"w": rs.randn(3, 5).astype(np.float32),
                        "b": rs.randn(5).astype(np.float32)},
             "state": {"m": rs.randn(4).astype(np.float32)}}
        out.append(t)
    return out


def _close(port_tree, ref_tree, tol):
    got = convert.leaves_with_paths(convert.tree_to_numpy(port_tree))
    want = convert.leaves_with_paths(jax.tree.map(np.asarray, ref_tree))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype, p
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=str(p))


def test_adamw_matches_reference():
    """Three AdamW steps (bias correction, decoupled decay, float32
    moments) from the same params and gradients; the count and the
    state's dtypes as the reference's."""
    rs = np.random.RandomState(3)
    tree = {"a": rs.randn(6, 4).astype(np.float32),
            "b": {"c": rs.randn(9).astype(np.float32)}}
    grads = [jax.tree.map(lambda x: rs.randn(*x.shape).astype(np.float32),
                          tree) for _ in range(3)]
    ij, uj = jopt.adamw(0.9, 0.95, 1e-8, 0.1)
    it, ut = topt.adamw(0.9, 0.95, 1e-8, 0.1)
    pj, sj = tree, ij(tree)
    pt = convert.tree_from_numpy(tree)
    st = it(pt)
    for g in grads:
        pj, sj = uj(pj, g, sj, jnp.float32(1e-2))
        pt, st = ut(pt, convert.tree_from_numpy(g), st, 1e-2)
    assert int(st.count) == int(sj.count) == 3
    assert st.count.dtype == torch.int32
    for port, ref in ((pt, pj), (st.mu, sj.mu), (st.nu, sj.nu)):
        got = convert.leaves_with_paths(convert.tree_to_numpy(port))
        for (p, a), b in zip(got, jax.tree.leaves(ref)):
            b = np.asarray(b)
            assert a.dtype == b.dtype == np.float32, p
            np.testing.assert_allclose(a, b, rtol=ADAM_REL,
                                       atol=ADAM_REL * np.abs(b).max())


def test_adamw_keeps_bfloat16_params_and_float32_moments():
    it, ut = topt.adamw()
    p = {"w": torch.randn(4, 4, generator=torch.Generator().manual_seed(0))
         .to(torch.bfloat16)}
    st = it(p)
    assert st.mu["w"].dtype == st.nu["w"].dtype == torch.float32
    p2, st2 = ut(p, {"w": torch.ones(4, 4, dtype=torch.bfloat16)}, st, 0.1)
    assert p2["w"].dtype == torch.bfloat16
    assert st2.mu["w"].dtype == torch.float32


@pytest.mark.parametrize("seed", [0, 1])
def test_token_view_on_the_reference_draws(seed):
    """`token_view` on the reference's drop mask (its bernoulli draw
    under the key, replayed) is bitwise the reference's view; the port's
    own draw drops at the rate asked for."""
    key = jax.random.PRNGKey(seed)
    toks = np.random.RandomState(seed).randint(1, 500, (6, 40)).astype(
        np.int32)
    want = np.asarray(jssl.token_view(key, jnp.asarray(toks), 0, 0.15))
    drop = np.asarray(jax.random.bernoulli(key, 0.15, toks.shape))
    got = tssl.token_view(_t(toks), 0, _t(drop))
    np.testing.assert_array_equal(got.numpy(), want)
    d = tssl.draw_token_view(torch.Generator().manual_seed(seed),
                             (64, 512), 0.15)
    assert d.dtype == torch.bool and d.shape == (64, 512)
    rate = float(d.float().mean())
    assert abs(rate - 0.15) < 5 * (0.15 * 0.85 / d.numel()) ** 0.5


def test_token_batch_and_category_histogram_bitwise():
    for seed, (b, s, v) in enumerate(((4, 64, 1024), (2, 7, 50))):
        np.testing.assert_array_equal(
            tdata.token_batch(np.random.RandomState(seed), b, s, v),
            jdata.token_batch(np.random.RandomState(seed), b, s, v))
    labels = np.random.RandomState(5).randint(0, 10, 200).astype(np.int32)
    parts = tdata.partition_dirichlet(labels, 4, 0.3, seed=2,
                                      min_per_client=5)
    got = tdata.category_histogram(labels, parts)
    np.testing.assert_array_equal(got,
                                  jdata.category_histogram(labels, parts))
    assert got.sum() == 200 and got.shape == (4, 10)


@pytest.mark.parametrize("n", [1, 3, 5])
def test_list_aggregators_match_reference(n):
    """aggregate_flsimco (normalised and not), aggregate_discard (below,
    straddling and above the threshold), aggregate_softmax and
    aggregate_inverse over lists of trees, and `aggregate_fedavg` as
    before."""
    rs = np.random.RandomState(n)
    trees = _trees(rs, n)
    port = [convert.tree_from_numpy(t) for t in trees]
    blur = (rs.uniform(16.67, 41.67, n) * 0.58).astype(np.float32)
    cases = [("aggregate_flsimco", (blur,), {}),
             ("aggregate_flsimco", (blur,), {"normalize": False}),
             ("aggregate_discard", (blur, 16.1), {}),
             ("aggregate_discard", (blur, 100.0), {}),
             ("aggregate_discard", (blur, 0.0), {}),
             ("aggregate_softmax", (blur,), {"temperature": 3.0}),
             ("aggregate_inverse", (blur,), {"eps": 0.5}),
             ("aggregate_fedavg", (), {})]
    for name, args, kw in cases:
        want = getattr(jagg, name)(trees, *args, **kw)
        targs = tuple(_t(a) if isinstance(a, np.ndarray) else a
                      for a in args)
        _close(getattr(tagg, name)(port, *targs, **kw), want, AGG_TOL)


def test_wagg_tree_and_stacked_match_reference():
    """`wagg_tree` over a list of trees and `wagg_stacked` over their
    stacked tree (with a mask) against the reference's, leaf dtypes
    kept (a bfloat16 leaf comes back bfloat16)."""
    rs = np.random.RandomState(9)
    trees = _trees(rs, 4)
    w = rs.rand(4).astype(np.float32)
    port = [convert.tree_from_numpy(t) for t in trees]
    _close(tops.wagg_tree(port, _t(w)), jops.wagg_tree(trees, w), AGG_TOL)
    stacked = jax.tree.map(lambda *x: np.stack(x), *trees)
    tstacked = convert.tree_from_numpy(stacked)
    mask = np.array([1, 0, 1, 1], np.float32)
    _close(tops.wagg_stacked(tstacked, _t(w), _t(mask)),
           jops.wagg_stacked(stacked, w, jnp.asarray(mask)), AGG_TOL)
    bf = {"x": torch.randn(3, 2, generator=torch.Generator().manual_seed(1))
          .to(torch.bfloat16)}
    out = tops.wagg_tree([bf, bf], torch.tensor([0.25, 0.75]))
    assert out["x"].dtype == torch.bfloat16
    assert torch.equal(out["x"], bf["x"])


def test_dt_loss_ref_matches_reference():
    rs = np.random.RandomState(4)
    q, k = (rs.randn(8, 32).astype(np.float32) for _ in range(2))
    q, k = (x / np.linalg.norm(x, axis=-1, keepdims=True) for x in (q, k))
    np.testing.assert_allclose(float(tref.dt_loss_ref(_t(q), _t(k))),
                               float(jref.dt_loss_ref(q, k)), rtol=1e-6)


def _defined(path) -> set:
    tree = ast.parse(open(path).read())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


def _methods(path) -> dict:
    """{public class: its public methods and properties, those of its
    bases defined in the same module included}."""
    tree = ast.parse(open(path).read())
    own = {n.name: ({b.name for b in n.body
                     if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))
                     and not b.name.startswith("_")},
                    [b.id for b in n.bases if isinstance(b, ast.Name)])
           for n in tree.body if isinstance(n, ast.ClassDef)}

    def resolve(name, seen=()):
        names, bases = own[name]
        out = set(names)
        for b in bases:
            if b in own and b not in seen:
                out |= resolve(b, seen + (name,))
        return out

    return {c: resolve(c) for c in own if not c.startswith("_")}


def _method_gap(ref, port) -> dict:
    ref_m, port_m = _methods(ref), _methods(port)
    return {c: m - port_m[c] for c, m in ref_m.items()
            if c in port_m and m - port_m[c]}


@pytest.mark.parametrize("level", ["function", "method"])
def test_function_level_diff_is_only_the_jax_and_tpu_names(level):
    """Every public function and class the reference defines, module by
    module, is defined by the port's module of the same path, except
    NOT_PORTED's names and NO_PORT_MODULE's modules; and (``method``)
    every public method of a class both define is the port's class's
    too, except NOT_PORTED_METHODS'."""
    ref_root = os.path.join(ROOT, "src", "repro")
    port_root = os.path.join(ROOT, "src", "repro_torch")
    missing, modules = {}, set()
    for dirpath, _, files in os.walk(ref_root):
        for f in files:
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), ref_root)
            port = os.path.join(port_root, rel)
            if not os.path.exists(port):
                modules.add(rel)
                continue
            ref = os.path.join(dirpath, f)
            gap = (_defined(ref) - _defined(port) if level == "function"
                   else _method_gap(ref, port))
            if gap:
                missing[rel] = gap
    assert modules == NO_PORT_MODULE
    assert missing == (NOT_PORTED if level == "function"
                       else NOT_PORTED_METHODS)


# --------------------------------------------------------------------------
# FederatedTrainer and the cohort's tree views
# --------------------------------------------------------------------------

def _trainer_inputs():
    rs = np.random.RandomState(2)
    data = [rs.rand(6, 4, 4, 3).astype(np.float32) for _ in range(4)]
    cfg = FLConfig(n_vehicles=4, vehicles_per_round=2, batch_size=2,
                   rounds=2, lr=0.4, seed=3)
    return cfg, data


def test_federated_trainer_rounds_are_run_rounds():
    """Two `round()` calls are two `run_round` calls from the same
    Scenario, bitwise; a mismatched round index raises as the
    reference's; `run` prints the reference's lines."""
    cfg, data = _trainer_inputs()
    tree = _narrow_tree()
    ft = FederatedTrainer(cfg, tree, data, device="cpu")
    recs = [ft.round(), ft.round(r=1)]
    with pytest.raises(ValueError, match="does not match state round 2"):
        ft.round(r=0)
    sc = Scenario(cfg, data=data, global_tree=tree, device="cpu")
    state, want = sc.init_state(), []
    for _ in range(2):
        state, rec = run_round(state, sc)
        want.append(rec)
    assert recs == want == ft.history
    assert ft.state.round == 2 and torch.equal(ft.key, state.gen_state)
    got = convert.leaves_with_paths(ft.global_tree)
    for (p, a), (_, b) in zip(got, convert.leaves_with_paths(
            state.global_tree)):
        assert torch.equal(a, b), p
    assert ft.lr_fn(1) == sc.lr_fn(1)


def test_federated_trainer_run_logs_and_names_match_reference(capsys):
    """The public attribute names of the port's trainer are the
    reference's (``key`` documented as the state's gen_state); `run`
    prints "[round N] loss=... lr=..." every `log_every` rounds."""
    cfg, data = _trainer_inputs()
    tree = _narrow_tree()
    ft = FederatedTrainer(cfg, tree, data, device="cpu")
    jtree = jax.tree.map(jnp.asarray, convert.tree_to_numpy(tree))
    jft = JFederatedTrainer(JFLConfig(**dataclasses.asdict(cfg)), jtree, data)

    def public(obj):
        return {n for n in dir(obj) if not n.startswith("_")}

    assert public(ft) == public(jft)
    assert "gen_state" in FederatedTrainer.key.__doc__
    assert ft.cfg is ft.scenario.cfg and ft.mobility is ft.scenario.mobility
    hist = ft.run(rounds=2, log_every=1)
    lines = capsys.readouterr().out.splitlines()
    assert [ln[:12] for ln in lines] == ["[round    0]", "[round    1]"]
    assert lines[1] == (f"[round    1] loss={hist[1]['loss']:.4f} "
                        f"lr={hist[1]['lr']:.4f}")


def _view_trees(rs, m):
    return [{"params": {"w": rs.randn(3, 2).astype(np.float32),
                        "b": rs.randn(4).astype(np.float32)},
             "state": {"m": rs.randn(2, 2).astype(np.float32)}}
            for _ in range(m)]


def _assert_tree_bitwise(port_tree, ref_tree):
    got = convert.leaves_with_paths(convert.tree_to_numpy(port_tree))
    want = convert.leaves_with_paths(jax.tree.map(np.asarray, ref_tree))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, p
        np.testing.assert_array_equal(a, b, err_msg=str(p))


def test_cohort_from_list_and_tree_views_match_reference():
    """`from_list`, `valid_trees` and `unstack` against the reference's
    on the same numpy trees, bitwise; the losses and mask too."""
    rs = np.random.RandomState(4)
    trees = _view_trees(rs, 3)
    losses = rs.rand(3).astype(np.float32)
    j = JCohortBatch.from_list([jax.tree.map(jnp.asarray, t) for t in trees],
                               [jnp.asarray(v) for v in losses])
    c = CohortBatch.from_list([convert.tree_from_numpy(t) for t in trees],
                              [torch.tensor(v) for v in losses])
    assert c.n == j.n == 3 and c.size == j.size
    np.testing.assert_array_equal(c.losses.numpy(), np.asarray(j.losses))
    np.testing.assert_array_equal(c.mask.numpy(), np.asarray(j.mask))
    _assert_tree_bitwise(c.valid_trees, j.valid_trees)
    for a, b in zip(c.unstack(), j.unstack(), strict=True):
        _assert_tree_bitwise(a, b)
    # the rows are the flat row layout of each tree
    for i, t in enumerate(trees):
        assert torch.equal(c.flat[i],
                           convert.ravel(convert.tree_from_numpy(t)))


def test_cohort_from_stacked_padding_and_velocities_match_reference():
    """`from_stacked` with padding rows (n < m) and stats against the
    reference's, bitwise: the stacked trees, the valid views, mask,
    velocities and `valid_velocities`; both raise without velocities."""
    rs = np.random.RandomState(5)
    trees = _view_trees(rs, 4)
    stacked = {k: {n: np.stack([t[k][n] for t in trees])
                   for n in trees[0][k]} for k in trees[0]}
    losses = rs.rand(4).astype(np.float32)
    vel = rs.uniform(17, 41, 4).astype(np.float32)
    j = JCohortBatch.from_stacked(jax.tree.map(jnp.asarray, stacked),
                                  jnp.asarray(losses), n=2,
                                  velocities=jnp.asarray(vel))
    c = CohortBatch.from_stacked(convert.tree_from_numpy(stacked),
                                 torch.from_numpy(losses), n=2,
                                 velocities=torch.from_numpy(vel))
    assert (c.n, c.size) == (j.n, j.size) == (2, 4)
    np.testing.assert_array_equal(c.mask.numpy(), np.asarray(j.mask))
    _assert_tree_bitwise(convert.unravel(c.flat, c.spec), j.trees)
    _assert_tree_bitwise(c.valid_trees, j.valid_trees)
    assert len(c.unstack()) == len(j.unstack()) == 2
    np.testing.assert_array_equal(c.valid_velocities.numpy(),
                                  np.asarray(j.valid_velocities))
    np.testing.assert_array_equal(c.valid_losses.numpy(),
                                  np.asarray(j.valid_losses))
    bare = CohortBatch.from_stacked(convert.tree_from_numpy(stacked),
                                    torch.from_numpy(losses))
    jbare = JCohortBatch.from_stacked(jax.tree.map(jnp.asarray, stacked),
                                      jnp.asarray(losses))
    for cohort in (bare, jbare):
        with pytest.raises(ValueError, match="no velocities attached"):
            cohort.valid_velocities
