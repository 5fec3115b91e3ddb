"""The port's zoo training path (RWKV6, ``ssm`` family) against the JAX
reference, on the CPU: the differentiable `ops.rwkv6`, the losses,
`forward_features`, `dt_objective` and `make_train_step`, and the
training driver `launch/train.py`.

The config is ``rwkv6-1.6b-smoke`` (2 layers, d_model 256, 4 heads of
64, d_ff 512, vocab 1024 padded to 2048) in float32, B = 4 sequences of
S = 37 tokens (the last chunk of 16 ragged). The reference's weights are
carried into the port with `convert.zoo_params_from_numpy`; tokens and
blur are numpy draws; the DT objective's drop masks are the reference's
own `PRNGKey(0)` draws, replayed into the port's step.

The reference's step runs under a one-device mesh whose axes are
``AxisType.Auto``: `repro.launch.mesh.make_host_mesh` builds Explicit
axes under jax 0.9, on which the reference's `with_sharding_constraint`
asserts (its own tests/test_system.py launch tests fail for that).

Tolerances, both sides float32: losses within LOSS_REL relative; each
gradient, parameter and momentum leaf within LEAF_REL of the leaf's
largest magnitude (the two frameworks sum the matmuls, norms and the
chunked recurrence in other orders; 3.6e-6 is the largest seen).

The card tests of the differentiable rwkv6 and of the DT kernel's wide
form live in tests/test_torch_kernels.py, which imports no jax.

    PYTHONPATH=src python -m pytest tests/test_torch_train.py
"""
from __future__ import annotations

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, Mesh

from repro import compat
from repro.configs.base import InputShape as JShape
from repro.configs.base import get_config as j_get_config
from repro.launch import steps as jst
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps as tst
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from test_torch_round import torch_threads  # noqa: F401 (autouse)

LOSS_REL = 1e-6
LEAF_REL = 2e-5
ARCH = "rwkv6-1.6b"
B, S = 4, 37


def _leaf_err(a, b) -> float:
    """max |a - b| over max |b|, in float64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _tree_errs(port_tree, ref_tree) -> dict:
    """Per-leaf `_leaf_err` of a port tree against a reference tree."""
    got = convert.leaves_with_paths(convert.tree_to_numpy(port_tree))
    want = convert.leaves_with_paths(jax.tree.map(np.asarray, ref_tree))
    assert [p for p, _ in got] == [p for p, _ in want]
    return {"/".join(p): _leaf_err(a, b) for (p, a), (_, b) in
            zip(got, want)}


@pytest.fixture(scope="module")
def cfgs():
    return j_get_config(ARCH).reduced(), get_config(ARCH + "-smoke")


@pytest.fixture(scope="module")
def model(cfgs):
    """Reference float32 params of the smoke config, as numpy leaves."""
    jcfg, _ = cfgs
    return jax.tree.map(np.asarray,
                        JT.init_params(jcfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("pod", "data", "model"), axis_types=(AxisType.Auto,) * 3)


def _tokens(seed, b=B, s=S, vocab=1024):
    return np.random.RandomState(seed).randint(1, vocab, (b, s)).astype(
        np.int32)


def _blur(seed, b=B):
    """Eq.-2 blur levels across the reference's velocity range, both sides
    of BLUR_KMH_100 (~16.1)."""
    return np.random.RandomState(seed).uniform(9.0, 25.0, b).astype(
        np.float32)


def _ref_drops(b_micro, s, n_micro):
    """The reference's two drop masks (its `dt_objective` under
    `PRNGKey(0)`, the same for every micro-batch) for a whole batch, as
    the port's (2, B, S) bool."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    d = [np.asarray(jax.random.bernoulli(k, 0.15, (b_micro, s)))
         for k in (k1, k2)]
    return torch.from_numpy(np.stack([np.tile(x, (n_micro, 1)) for x in d]))


# --------------------------------------------------------------------------
# the differentiable rwkv6
# --------------------------------------------------------------------------

def _rwkv6_leaves(seed, bh, s, d, with_state):
    rs = np.random.RandomState(seed)
    r, k, v = ((rs.randn(bh, s, d) * 0.5).astype(np.float32)
               for _ in range(3))
    lw = np.clip(-np.exp(rs.randn(bh, s, d) * 0.3 - 1.0), -4.0, -1e-4)
    u = (rs.randn(bh, d) * 0.3).astype(np.float32)
    s0 = (rs.randn(bh, d, d) * 0.3).astype(np.float32)
    leaves = [torch.from_numpy(x).requires_grad_()
              for x in (r, k, v, lw.astype(np.float32), u)]
    if with_state:
        leaves.append(torch.from_numpy(s0).requires_grad_())
    go = torch.from_numpy(rs.randn(bh, s, d).astype(np.float32))
    gs = torch.from_numpy(rs.randn(bh, d, d).astype(np.float32))
    return leaves, go, gs


def _grads(fn, leaves, go, gs):
    args = leaves + [None] * (6 - len(leaves))
    o, st = fn(*args)
    return torch.autograd.grad((o * go).sum() + (st * gs).sum(), leaves)


@pytest.mark.parametrize("s", [16, 37, 64])
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_gradients_match_the_sequential_oracle(s, with_state):
    """Gradients of (o, state) with respect to r, k, v, logw, u (and
    state0) through `ops.rwkv6`'s Function against autograd through the
    token-by-token oracle `ref.rwkv6_ref`."""
    leaves, go, gs = _rwkv6_leaves(s + 7 * with_state, 3, s, 16, with_state)
    got = _grads(ops.rwkv6, leaves, go, gs)
    want = _grads(ref.rwkv6_ref, leaves, go, gs)
    for g, w in zip(got, want):
        assert _leaf_err(g, w) <= LEAF_REL


def test_rwkv6_function_takes_the_projection_layout():
    """(B, S, H, D) inputs with u (H, D) and state0 (B, H, D, D): the
    gradients (u's summed over the batch) match autograd through the
    plain version on the same layout, and no grad-free call records a
    graph."""
    rs = np.random.RandomState(5)
    b, s, h, d = 2, 37, 3, 16

    def leaf(shape, scale):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(
            np.float32)).requires_grad_()

    r, k, v = (leaf((b, s, h, d), 0.5) for _ in range(3))
    lw = torch.clamp(-torch.exp(leaf((b, s, h, d), 0.3) - 1.0), -4.0,
                     -1e-4).detach().requires_grad_()
    u, s0 = leaf((h, d), 0.3), leaf((b, h, d, d), 0.3)
    leaves = [r, k, v, lw, u, s0]
    go = torch.randn(b, s, h, d, generator=torch.Generator().manual_seed(1))
    gs = torch.randn(b, h, d, d, generator=torch.Generator().manual_seed(2))
    got = _grads(ops.rwkv6, leaves, go, gs)
    want = _grads(ops.rwkv6_plain, leaves, go, gs)
    for g, w in zip(got, want):
        assert g.shape == w.shape and _leaf_err(g, w) <= LEAF_REL
    with torch.no_grad():
        o, st = ops.rwkv6(*leaves)
    assert o.grad_fn is None and st.grad_fn is None


def test_chunk_carry_matches_a_loop():
    """The grouped state carry (two levels of recursion at n = 300 steps,
    groups of 16) against the step-by-step recurrence."""
    rs = np.random.RandomState(3)
    lam = torch.from_numpy(-rs.uniform(0.0, 8.0, (2, 300, 5)).astype(
        np.float32))
    inc = torch.from_numpy(rs.randn(2, 300, 5, 3).astype(np.float32))
    s0 = torch.from_numpy(rs.randn(2, 5, 3).astype(np.float32))
    got = ref.chunk_carry(lam, inc, s0)
    st, want = s0, []
    for c in range(300):
        st = torch.exp(lam[:, c])[..., None] * st + inc[:, c]
        want.append(st)
    torch.testing.assert_close(got, torch.stack(want, 1), atol=1e-5,
                               rtol=1e-5)


def test_rwkv6_parallel_form_matches_the_chunk_loop():
    """`rwkv6_chunked_parallel` against `rwkv6_chunked_ref` at a ragged S
    over 19 chunks (the carry's recursion), with a state."""
    leaves, _, _ = _rwkv6_leaves(11, 2, 300, 16, True)
    with torch.no_grad():
        o1, s1 = ref.rwkv6_chunked_ref(*leaves)
        o2, s2 = ref.rwkv6_chunked_parallel(*leaves)
    torch.testing.assert_close(o2, o1, atol=2e-5, rtol=0)
    torch.testing.assert_close(s2, s1, atol=2e-5, rtol=0)


def test_tmix_gradients_match_jax_grad(cfgs, model):
    """Gradients of `rwkv_tmix_chunked` (with a carried state and token)
    with respect to every time-mix leaf, x, state and x_last, against
    `jax.grad` of the reference's (S = 37: its 32 + 5 split)."""
    jcfg, tcfg = cfgs
    d, hd = jcfg.d_model, jcfg.rwkv_head_dim
    h = d // hd
    rs = np.random.RandomState(9)
    x = (rs.randn(2, S, d) * 0.5).astype(np.float32)
    st = (rs.randn(2, h, hd, hd) * 0.3).astype(np.float32)
    xl = (rs.randn(2, d) * 0.5).astype(np.float32)
    go = rs.randn(2, S, d).astype(np.float32)
    gs = rs.randn(2, h, hd, hd).astype(np.float32)
    p = jax.tree.map(lambda t: t[0], model["blocks"]["tmix"])

    def jloss(p, x, st, xl):
        o, s_new, _ = JL.rwkv_tmix_chunked(jcfg, p, x, st, xl)
        return jnp.sum(o * go) + jnp.sum(s_new * gs)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(p, x, st, xl)
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in p.items()}
    tx, tst_, txl = (torch.from_numpy(a.copy()).requires_grad_()
                     for a in (x, st, xl))
    o, s_new, _ = TL.rwkv_tmix_chunked(tcfg, tp, tx, tst_, txl)
    loss = (o * torch.from_numpy(go)).sum() \
        + (s_new * torch.from_numpy(gs)).sum()
    names = sorted(tp)
    got = torch.autograd.grad(loss, [tp[n] for n in names]
                              + [tx, tst_, txl])
    for n, g in zip(names, got):
        assert _leaf_err(g, want[0][n]) <= LEAF_REL, n
    for g, w in zip(got[len(names):], want[1:]):
        assert _leaf_err(g, w) <= LEAF_REL


# --------------------------------------------------------------------------
# leaf functions
# --------------------------------------------------------------------------

def test_example_weights_match_reference():
    """Eq. 11 against the reference's `_flsimco_example_weights`; fedavg
    and discard against the reference step's expressions."""
    from repro.core.mobility import BLUR_KMH_100
    blur = _blur(0, 8)
    tb = torch.from_numpy(blur)
    np.testing.assert_allclose(
        tst.example_weights(tb, "flsimco").numpy(),
        np.asarray(jst._flsimco_example_weights(jnp.asarray(blur))),
        rtol=1e-6, atol=0)
    keep = (blur <= BLUR_KMH_100).astype(np.float32)
    assert 0 < keep.sum() < len(blur)
    np.testing.assert_allclose(tst.example_weights(tb, "discard").numpy(),
                               keep / max(keep.sum(), 1.0), rtol=1e-6)
    np.testing.assert_allclose(tst.example_weights(tb, "fedavg").numpy(),
                               np.full(8, 1 / 8, np.float32), rtol=0)
    with pytest.raises(ValueError):
        tst.example_weights(tb, "mean")


@pytest.mark.parametrize("mode", ["onehot", "gather"])
def test_lm_loss_per_example_matches_both_reference_modes(cfgs, mode):
    jcfg, tcfg = cfgs
    rs = np.random.RandomState(4)
    logits = (rs.randn(B, S, jcfg.padded_vocab) * 3).astype(np.float32)
    logits[..., jcfg.vocab_size:] = TL.NEG_INF
    toks = _tokens(4)
    want = np.asarray(jst.lm_loss_per_example(
        jcfg, jnp.asarray(logits), jnp.asarray(toks), mode=mode))
    got = tst.lm_loss_per_example(tcfg, torch.from_numpy(logits),
                                  torch.from_numpy(toks.astype(np.int64)))
    np.testing.assert_allclose(got.numpy(), want, rtol=LOSS_REL, atol=0)


def test_forward_features_match_reference(cfgs, model):
    jcfg, tcfg = cfgs
    toks = _tokens(6)
    want, aux = JT.forward_features(jcfg, model, jnp.asarray(toks))
    tp = convert.zoo_params_from_numpy(model, device="cpu")
    got, t_aux = TT.forward_features(tcfg, tp,
                                     torch.from_numpy(toks.astype(np.int64)))
    assert got.dtype == torch.float32 and got.shape == (B, jcfg.d_model)
    assert _leaf_err(got, want) <= LEAF_REL
    torch.testing.assert_close(torch.linalg.vector_norm(got, dim=-1),
                               torch.ones(B))
    assert float(t_aux) == float(aux) == 0.0


def test_dt_objective_with_the_reference_masks(cfgs, model):
    """The reference's `dt_objective` under `PRNGKey(0)`, and the port's
    with those masks replayed."""
    jcfg, tcfg = cfgs
    toks = _tokens(7)
    want = float(jst.dt_objective(jcfg, model, jnp.asarray(toks),
                                  jax.random.PRNGKey(0)))
    tp = convert.zoo_params_from_numpy(model, device="cpu")
    drops = _ref_drops(B, S, 1)
    assert 0 < int(drops.sum()) < drops.numel()
    got = float(tst.dt_objective(tcfg, tp, torch.from_numpy(
        toks.astype(np.int64)), drops))
    assert abs(got - want) <= LOSS_REL * abs(want)


def test_drop_masks_are_the_planned_draws():
    """Two views' masks from a CPU generator: bool (2, B, S), about DROP_P
    dropped, the same draws for the same seed."""
    a = tst.draw_drop_masks((64, 128), torch.Generator().manual_seed(0))
    b = tst.draw_drop_masks((64, 128), torch.Generator().manual_seed(0))
    assert a.dtype == torch.bool and a.shape == (2, 64, 128)
    assert torch.equal(a, b) and not torch.equal(a[0], a[1])
    assert abs(float(a.float().mean()) - tst.DROP_P) < 0.01


@pytest.mark.parametrize("b,s", [(256, 4096), (8, 4096), (4, 64), (1, 32)])
def test_pick_n_micro_matches_reference(cfgs, mesh, b, s):
    jcfg, tcfg = cfgs
    full = j_get_config(ARCH), get_config(ARCH)
    for jc, tc in (cfgs, full):
        assert tst.pick_n_micro(tc, InputShape("t", s, b, "train")) == \
            jst.pick_n_micro(jc, JShape("t", s, b, "train"), mesh)


# --------------------------------------------------------------------------
# the train step against the reference's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("objective,optimizer,n_micro,steps,wd,agg", [
    ("lm", "sgdm", 1, 1, 0.0, "flsimco"),    # momentum = the gradients
    ("lm", "sgd", 2, 1, 5e-4, "fedavg"),
    ("lm", "sgdm", 2, 2, 5e-4, "discard"),
    ("dt", "sgdm", 1, 1, 0.0, "flsimco"),    # momentum = the gradients
    ("dt", "sgdm", 2, 1, 5e-4, "flsimco"),
])
def test_train_step_matches_reference(cfgs, model, mesh, objective,
                                      optimizer, n_micro, steps, wd, agg):
    """`make_train_step` against the reference's own, jitted under the
    Auto-axis one-device mesh, from the reference's params: the loss of
    each step, then every parameter and momentum leaf. With weight decay
    0 the momentum after one step from zero is the accumulated gradient
    itself."""
    jcfg, tcfg = cfgs
    kw = dict(objective=objective, optimizer=optimizer, n_micro=n_micro,
              weight_decay=wd, aggregation=agg)
    jfn, jnm = jst.make_train_step(jcfg, JShape("t", S, B, "train"), mesh,
                                   **kw)
    tfn, tnm = tst.make_train_step(tcfg, InputShape("t", S, B, "train"),
                                   **kw)
    assert jnm == tnm == n_micro
    jp, jm = model, jst.init_momentum(model, optimizer)
    tp = convert.zoo_params_from_numpy(model, device="cpu")
    tm = tst.init_momentum(tp, optimizer)
    assert _tree_errs(tm, jm) == {k: 0.0 for k in _tree_errs(tm, jm)}
    jstep = jax.jit(jfn)
    for i in range(steps):
        toks, blur = _tokens(10 + i), _blur(10 + i)
        with compat.set_mesh(mesh):
            jp, jm, jmet = jstep(jp, jm, {"tokens": jnp.asarray(toks),
                                          "blur": jnp.asarray(blur)})
        batch = {"tokens": torch.from_numpy(toks.astype(np.int64)),
                 "blur": torch.from_numpy(blur)}
        if objective == "dt":
            batch["drops"] = _ref_drops(B // n_micro, S, n_micro)
        tp, tm, tmet = tfn(tp, tm, batch)
        want = float(jmet["loss"])
        assert abs(float(tmet["loss"]) - want) <= LOSS_REL * abs(want), i
    for name, tree, ref_tree in (("params", tp, jp), ("momentum", tm, jm)):
        errs = _tree_errs(tree, ref_tree)
        worst = max(errs, key=errs.get)
        assert errs[worst] <= LEAF_REL, (name, worst, errs[worst])


def test_train_step_leaves_its_inputs_and_refuses_bad_names(cfgs, model):
    _, tcfg = cfgs
    tp = convert.zoo_params_from_numpy(model, device="cpu")
    before = convert.tree_to_numpy(tp)
    fn, _ = tst.make_train_step(tcfg, InputShape("t", S, B, "train"),
                                n_micro=1)
    tm = tst.init_momentum(tp)
    fn(tp, tm, {"tokens": torch.from_numpy(_tokens(1).astype(np.int64)),
                "blur": torch.from_numpy(_blur(1))})
    for (_, a), (_, b) in zip(
            convert.leaves_with_paths(convert.tree_to_numpy(tp)),
            convert.leaves_with_paths(before)):
        assert np.array_equal(a, b)
    assert all(float(t.abs().max()) == 0 for _, t in
               convert.leaves_with_paths(tm))
    shape = InputShape("t", S, B, "train")
    for kw in ({"objective": "mlm"}, {"optimizer": "adam"},
               {"aggregation": "mean"}):
        with pytest.raises(ValueError):
            tst.make_train_step(tcfg, shape, **kw)
    fn3, _ = tst.make_train_step(tcfg, shape, n_micro=3)
    with pytest.raises(ValueError, match="micro-batches"):
        fn3(tp, tm, {"tokens": torch.ones((B, S), dtype=torch.int64),
                     "blur": torch.ones(B)})
    fn_dt, _ = tst.make_train_step(tcfg, shape, objective="dt", n_micro=1)
    with pytest.raises(ValueError, match="drop masks"):
        fn_dt(tp, tm, {"tokens": torch.ones((B, S), dtype=torch.int64),
                       "blur": torch.ones(B)})


# --------------------------------------------------------------------------
# the driver
# --------------------------------------------------------------------------

@pytest.mark.parametrize("objective", ["lm", "dt"])
def test_train_launcher_reduced_on_cpu(capsys, objective):
    ttrain.main(["--reduced", "--device", "cpu", "--steps", "2",
                 "--objective", objective])
    out = capsys.readouterr().out
    assert re.search(r"train rwkv6-1.6b-smoke on cpu: 4 x 64 tokens a step, "
                     rf"micro=1 objective={objective}", out), out
    losses = re.findall(r"step (\d): loss=([-\d.]+) \(", out)
    assert [s for s, _ in losses] == ["0", "1"], out
    assert all(np.isfinite(float(v)) for _, v in losses)


def test_train_launcher_batches_are_planned_draws(cfgs):
    """Tokens in [1, vocab), blur within the mobility model's range, the
    same batch for the same (seed, step), another for the next step."""
    _, tcfg = cfgs
    shape = InputShape("cpu", 64, 4, "train")
    a = ttrain.make_batch(tcfg, shape, 0, 0, "cpu", "dt")
    b = ttrain.make_batch(tcfg, shape, 0, 0, "cpu", "dt")
    c = ttrain.make_batch(tcfg, shape, 1, 0, "cpu", "dt")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["tokens"], c["tokens"])
    assert int(a["tokens"].min()) >= 1
    assert int(a["tokens"].max()) < tcfg.vocab_size
    assert a["drops"].shape == (2, 4, 64)
    lo, hi = 0.58 * 16.67, 0.58 * 41.67
    assert bool(((a["blur"] >= lo - 1e-3) & (a["blur"] <= hi + 1e-3)).all())


def test_train_launcher_refuses_multi_pod():
    """``--multi-pod`` at one rank: the (pod=2, data, model) mesh needs an
    even number of ranks, refused before any group is made."""
    with pytest.raises(ValueError, match="do not split into 2 pod"):
        ttrain.main(["--device", "cpu", "--multi-pod"])
    assert not torch.distributed.is_initialized()


def test_train_launcher_sim_round_checkpoint_and_resume(capsys, tmp_path):
    """``--mode sim``: two rounds with a checkpoint a round; then the
    LATEST pointer set back to round 1 and a resume, whose round 1 prints
    the same loss as the straight run's (the CPU round is deterministic
    and the restored state bitwise)."""
    argv = ["--mode", "sim", "--device", "cpu", "--rounds", "2",
            "--vehicles", "4", "--per-round", "2", "--batch", "4",
            "--n-per-class", "10", "--ckpt-dir", str(tmp_path)]
    ttrain.main(argv)
    out = capsys.readouterr().out
    losses = dict(re.findall(r"round (\d): loss=([-\d.]+)", out))
    assert set(losses) == {"0", "1"}, out
    assert sorted(os.listdir(tmp_path)) == [
        "LATEST", "ckpt_1.npz", "ckpt_1.npz.meta.json", "ckpt_2.npz",
        "ckpt_2.npz.meta.json"]
    with open(tmp_path / "LATEST", "w") as f:
        json.dump({"path": "ckpt_1.npz", "step": 1}, f)
    ttrain.main(argv + ["--resume"])
    out = capsys.readouterr().out
    assert "(round 1)" in out and "round 0:" not in out, out
    assert dict(re.findall(r"round (\d): loss=([-\d.]+)", out)) == \
        {"1": losses["1"]}
