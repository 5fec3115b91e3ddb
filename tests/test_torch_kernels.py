"""The port's kernel wrappers (repro_torch.kernels) against the reference.

On the CPU each wrapper runs its plain version; these tests hold that
path against the reference's Pallas kernel in interpret mode (`wagg`) or
its jnp oracle (`dt_loss`: the Pallas DT kernel calls `pl.load`, which
the installed jax no longer has). The q8 codec's CPU parity tests live
in tests/test_torch_comms.py and the rwkv6 ones in tests/test_torch_zoo.py.
Tests marked ``cuda`` hold the CUDA kernels against the plain versions on
the card and skip without one; chip_smoke.py runs the same checks at the
main path's shapes. The MoE block and the hybrid family's selective SSM
(plain torch, no kernel of their own) are held card against CPU here
too, since this file imports no jax.

The reference is imported inside the `jx` fixture, not at the top, so
that on a GPU machine without jax the ``cuda`` tests still run:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import dt_loss as dt_kernel
from repro_torch.kernels import qdelta as q8_kernel
from repro_torch.kernels import rwkv6 as rwkv6_kernel
from repro_torch.kernels import wagg as wagg_kernel

WAGG_TOL = 1e-5       # f32 sums of <= 16 terms in another order
DT_FWD_TOL = 2e-5     # logsumexp at tau 0.1 over up to 512 columns
DT_GRAD_TOL = 1e-5
DT_TAUS = ((0.1, 1.0), (0.07, 1.0), (0.2, 0.2))
# float32 sums of 16-80 terms and the chunk's prefix sums in another order
# than torch's (a few ULP in the exponents); the reference's own kernel
# tolerance (tests/test_kernels.py)
RWKV6_TOL = 2e-4
# steps per slab of csrc/rwkv6.cu (its constant T); the card tests put S
# on the slab edges
RWKV6_SLAB = 8
# the DT kernel's wide form (csrc/dt_loss.cu kWide*): CTAs a cluster,
# anchor rows a cluster, keys a CTA tile, consumer warps (two a key block
# of 16), ring stages, columns of D a stage at M >= 32, the widest D
WIDE_CLUSTER, WIDE_ROWS, WIDE_KEYS, WIDE_WARPS = 8, 32, 64, 8
WIDE_STAGES, WIDE_STAGE_COLS, WIDE_MAX_D = 4, 64, 8192


@pytest.fixture
def jx():
    """The JAX reference (skips where jax is not installed)."""
    jax = pytest.importorskip("jax")
    from repro.core.dt_loss import dt_loss_matrix
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return SimpleNamespace(jax=jax, jnp=jax.numpy, ops=jops, ref=jref,
                           dt_loss_matrix=dt_loss_matrix)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU mode)")
    return torch.device("cuda")


def _unit(rs, shape):
    x = rs.randn(*shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


# --------------------------------------------------------------------------
# wagg
# --------------------------------------------------------------------------

@pytest.mark.parametrize("N", [2, 5, 16])
@pytest.mark.parametrize("P", [1000, 2048, 5003])
def test_wagg_flat_matches_pallas_interpret(jx, N, P):
    jnp, jops = jx.jnp, jx.ops
    rs = np.random.RandomState(N * 7919 + P)
    x = rs.randn(N, P).astype(np.float32)
    w = rs.dirichlet(np.ones(N)).astype(np.float32)
    mask = (rs.rand(N) < 0.7).astype(np.float32)
    mask[0] = 1.0
    want = np.asarray(jops.wagg_flat(jnp.asarray(x), jnp.asarray(w),
                                     interpret=True))
    got = ops.wagg_flat(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, atol=WAGG_TOL)
    want_m = np.asarray(jops.wagg_flat(jnp.asarray(x), jnp.asarray(w),
                                       interpret=True,
                                       mask=jnp.asarray(mask)))
    got_m = ops.wagg_flat(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(mask))
    np.testing.assert_allclose(got_m.numpy(), want_m, atol=WAGG_TOL)


@pytest.mark.parametrize("n,m", [(1, 2), (5, 8), (3, 4)])
def test_wagg_masked_padded_is_bitwise_unpadded(n, m):
    rs = np.random.RandomState(n + 10 * m)
    x = torch.from_numpy(rs.randn(n, 777).astype(np.float32))
    w = torch.from_numpy(rs.rand(n).astype(np.float32))
    xp = torch.cat([x, x[-1:].expand(m - n, -1)])
    wp = torch.cat([w, torch.zeros(m - n)])
    mp = (torch.arange(m) < n).float()
    out_p = ops.wagg_flat(xp, wp, mp)
    assert torch.equal(out_p, ops.wagg_flat(x, w, torch.ones(n)))
    assert torch.equal(out_p, ops.wagg_flat(x, w))


def test_wrappers_refuse_mixed_and_non_cuda_inputs():
    x, w = torch.zeros(2, 8), torch.ones(2)
    with pytest.raises(ValueError):
        wagg_kernel.wagg_cuda(x, w)
    with pytest.raises(ValueError):
        dt_kernel.dt_loss_fwd_cuda(x, x, 0.1, 1.0)
    with pytest.raises(ValueError):
        q8_kernel.q8_encode_cuda(torch.zeros(2, 256), torch.zeros(2, 256))
    with pytest.raises(ValueError):
        q8_kernel.q8_decode_cuda(torch.zeros(2, 256, dtype=torch.int8),
                                 torch.zeros(2, 1))
    with pytest.raises(ValueError):
        ops._on_cuda(x, torch.empty(0, device="meta"))
    r = torch.zeros(2, 16, 32)
    with pytest.raises(ValueError):
        rwkv6_kernel.rwkv6_cuda(r, r, r, r, torch.zeros(32))


def test_build_finds_every_kernel_source():
    assert build.sources() == ["dt_loss", "qdelta", "rwkv6", "wagg"]
    t = build._target("wagg")
    assert t.parent == build.BUILD_DIR and t.name.startswith("wagg-")
    assert build._target("wagg") == t          # keyed on content only


def test_rwkv6_source_knobs_match_the_tests():
    """The kernel's slab length is the one the card tests put S around."""
    src = (build.CSRC / "rwkv6.cu").read_text()
    assert f"constexpr int T = {RWKV6_SLAB};" in src


def test_dt_loss_wide_source_knobs_match_the_tests():
    """The wide form's tiles, ring and cluster are the ones that
    `_wide_sim` and the note assume, and its widest D is the wrapper's."""
    src = (build.CSRC / "dt_loss.cu").read_text()
    for name, value in (("kWideCluster", WIDE_CLUSTER),
                        ("kWideRows", WIDE_ROWS), ("kWideKeys", WIDE_KEYS),
                        ("kWideWarps", WIDE_WARPS),
                        ("kWideStages", WIDE_STAGES),
                        ("kWideStageCols", WIDE_STAGE_COLS),
                        ("kWideMaxD", WIDE_MAX_D)):
        assert f"constexpr int {name} = {value};" in src, name
    assert dt_kernel.WIDE_MAX_D == WIDE_MAX_D
    assert "n_valid <= kWideKeys ?" in src     # the split rule


@pytest.mark.parametrize("d", [256, 1026, 8196])
def test_dt_loss_wide_attributes_refuse_widths_the_form_does_not_take(d):
    """The wide form's attributes are asked only for 256 < D <= 8192 with
    D % 4 == 0; another D is refused before any build."""
    with pytest.raises(ValueError, match="dt_loss wide form takes D"):
        dt_kernel.wide_kernel_attributes(d)


def test_rwkv6_attributes_refuse_other_head_dims():
    """Only the kernel's template instances (D = 32, 64) are asked for
    their attributes; another D is refused before any build."""
    assert rwkv6_kernel.HEAD_DIMS == (32, 64)
    for d in (16, 48, 128):
        with pytest.raises(ValueError, match="rwkv6 kernel takes D"):
            rwkv6_kernel.kernel_attributes(d)


@pytest.mark.parametrize("d", [0, 6, 260])
def test_dt_loss_attributes_refuse_widths_the_kernel_does_not_take(d):
    """A width the kernel refuses (D % 4 != 0 or D > 256) is refused
    before any build."""
    with pytest.raises(ValueError, match="dt_loss kernel takes D"):
        dt_kernel.kernel_attributes(d)


# --------------------------------------------------------------------------
# dt_loss
# --------------------------------------------------------------------------

@pytest.mark.parametrize("M", [96, 130, 512])
@pytest.mark.parametrize("D", [32, 128])
def test_dt_loss_fwd_matches_reference(jx, M, D):
    rs = np.random.RandomState(M * 131 + D)
    q, k = _unit(rs, (M, D)), _unit(rs, (M, D))
    jnp = jx.jnp
    want = jx.ref.dt_loss_fwd_ref(jnp.asarray(q), jnp.asarray(k), 0.1, 1.0)
    got = ops.dt_loss_fwd(torch.from_numpy(q), torch.from_numpy(k), 0.1, 1.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=DT_FWD_TOL)
    loss = ops.dt_loss(torch.from_numpy(q), torch.from_numpy(k), 0.1, 1.0)
    np.testing.assert_allclose(float(loss), float(np.asarray(want[0]).mean()),
                               atol=DT_FWD_TOL)


@pytest.mark.parametrize("taus", [(0.07, 1.0), (0.1, 0.5), (0.2, 0.2)])
def test_dt_loss_grad_matches_reference(jx, taus):
    ta, tb = taus
    rs = np.random.RandomState(11)
    q, k = _unit(rs, (64, 32)), _unit(rs, (64, 32))
    gq_j, gk_j = jx.jax.grad(lambda a, b: jx.dt_loss_matrix(a, b, ta, tb),
                             (0, 1))(jx.jnp.asarray(q), jx.jnp.asarray(k))
    qt = torch.from_numpy(q).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    gq, gk = torch.autograd.grad(ops.dt_loss(qt, kt, ta, tb), (qt, kt))
    np.testing.assert_allclose(gq.numpy(), np.asarray(gq_j), atol=DT_GRAD_TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(gk_j), atol=DT_GRAD_TOL)


def _rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: float32 rounded to 10 mantissa bits, to nearest
    with ties away from zero, on the bits (adding half an ULP of TF32 to
    the magnitude and cutting the 13 low bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _sim_tf32(q: torch.Tensor, k: torch.Tensor, passes: int) -> torch.Tensor:
    """q k^T as csrc/dt_loss.cu forms it: 3 passes are hi*hi + (lo*hi +
    hi*lo) with hi = rna(x), lo = rna(x - hi); 1 pass is hi*hi alone.
    Products of TF32 values are exact in float32; the sums are float32."""
    qh, kh = _rna_tf32(q), _rna_tf32(k)
    big = qh @ kh.T
    if passes == 1:
        return big
    ql, kl = _rna_tf32(q - qh), _rna_tf32(k - kh)
    return big + (ql @ kh.T + qh @ kl.T)


def _wide_sim(q: torch.Tensor, k: torch.Tensor, passes: int) -> torch.Tensor:
    """q k^T as the wide form forms it. The nph warps that share a key
    block take every nph-th k8 step of each stage; a similarity is their
    partials summed in phase order, each one 3xTF32 (`_sim_tf32`) over
    its columns. More keys than one key tile: the ranks split the keys and
    a key block's two warps split each 64-column stage (nph = 2). Else the
    split rule gives rank r the stages [r * per, (r + 1) * per), per =
    ceil(stages / WIDE_CLUSTER), a stage taking as many WIDE_STAGE_COLS
    columns as fit a ring slot at this M's tile but no more than give
    every rank a stage; each rank sums its phases, then rank 0 sums the
    ranks in order, in float32. (The wide form accumulates lo*hi and
    hi*lo in one accumulator: the same small sum, in another order.)"""
    m, d = q.shape

    def phases(stage_cols, stages, nph):
        out = None
        for p in range(nph):
            cols = [c for st in stages for kk in range(p, stage_cols // 8, nph)
                    for c in range(st * stage_cols + 8 * kk,
                                   st * stage_cols + 8 * kk + 8) if c < d]
            part = (_sim_tf32(q[:, cols], k[:, cols], passes) if cols
                    else torch.zeros((m, m), dtype=torch.float32))
            out = part if out is None else out + part
        return out

    if m > WIDE_KEYS:
        return phases(WIDE_STAGE_COLS, range(-(-d // WIDE_STAGE_COLS)), 2)
    qr, kr = -(-min(m, WIDE_ROWS) // 8) * 8, -(-min(m, WIDE_KEYS) // 8) * 8
    fit = WIDE_STAGE_COLS * (WIDE_ROWS + WIDE_KEYS) // (WIDE_STAGE_COLS
                                                        * (qr + kr))
    spread = -(-d // (WIDE_CLUSTER * WIDE_STAGE_COLS))
    stage_cols = WIDE_STAGE_COLS * (max(fit, 1) if fit < spread else spread)
    stages = -(-d // stage_cols)
    per = -(-stages // WIDE_CLUSTER)
    nkb = 1 if m <= 16 else 2 if m <= 32 else 4     # key blocks of 16
    sim = torch.zeros((m, m), dtype=torch.float32)
    for r in range(WIDE_CLUSTER):
        sim = sim + phases(stage_cols, range(r * per, min(stages,
                                                          (r + 1) * per)),
                           WIDE_WARPS // nkb)
    return sim


def _dt_err_vs_f64(M, D, passes, taus):
    rs = np.random.RandomState(M * 7 + D)
    q, k = _unit(rs, (M, D)), _unit(rs, (M, D))
    qt, kt = torch.from_numpy(q), torch.from_numpy(k)
    want = ref.dt_loss_from_sim(qt.double() @ kt.double().T, *taus)
    sim = (_wide_sim if dt_kernel.MAX_D < D else _sim_tf32)(qt, kt, passes)
    got = ref.dt_loss_from_sim(sim, *taus)
    return max(float((a.double() - b).abs().max()) for a, b in zip(got, want))


def test_rna_tf32_rounds_to_nearest_away():
    one = 1.0 + 2.0 ** -10                       # a TF32 value
    x = torch.tensor([1.0 + 2.0 ** -11,          # tie: away from zero
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, one],
                     dtype=torch.float32)
    assert _rna_tf32(x).tolist() == [one, -one, 1.0, one]


@pytest.mark.parametrize("M,D", [(512, 128), (64, 256), (8, 8192), (16, 896),
                                 (1, 7168), (512, 2048)])
@pytest.mark.parametrize("taus", DT_TAUS)
def test_dt_loss_3xtf32_sim_within_fwd_tol(M, D, taus):
    """The kernel's 3xTF32 similarity, fed through the plain version's
    arithmetic, stays within DT_FWD_TOL of the float64 result; for the
    wide form (D > 256) summed over its D split as rank 0 sums it."""
    assert _dt_err_vs_f64(M, D, 3, taus) <= DT_FWD_TOL


@pytest.mark.parametrize("M,D", [(512, 128), (64, 256), (16, 896)])
def test_dt_loss_1xtf32_sim_misses_fwd_tol(M, D):
    """One TF32 product (about 11 bits) does not: why the kernel pays for
    three."""
    assert _dt_err_vs_f64(M, D, 1, (0.1, 1.0)) > DT_FWD_TOL


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("N,P", [(5, 4096), (3, 1001), (16, 70000)])
def test_wagg_kernel_matches_plain_on_card(cuda, N, P):
    g = torch.Generator(device=cuda).manual_seed(N + P)
    x = torch.randn((N, P), generator=g, device=cuda)
    w = torch.softmax(torch.randn(N, generator=g, device=cuda), 0)
    mask = (torch.arange(N, device=cuda) % 3 != 2).float()
    before = wagg_kernel.LAUNCHES
    out = ops.wagg_flat(x, w, mask)
    assert wagg_kernel.LAUNCHES == before + 1
    torch.testing.assert_close(out, ref.wagg_ref(x, w, mask), atol=WAGG_TOL,
                               rtol=0)
    xp = torch.cat([x, x[-1:].expand(3, -1)]).contiguous()
    wp = torch.cat([w, w.new_zeros(3)])
    mp = torch.cat([torch.ones_like(w), w.new_zeros(3)])
    assert torch.equal(ops.wagg_flat(xp, wp, mp), ops.wagg_flat(x, w))
    # a misaligned stack takes the column-by-column branch: same sums
    xm = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(N, P)
    assert xm.is_contiguous() and xm.data_ptr() % 16
    assert torch.equal(ops.wagg_flat(xm, w, mask), out)
    with pytest.raises(ValueError):
        ops.wagg_flat(x.double(), w.double())


@pytest.mark.cuda
@pytest.mark.parametrize("M,D", [(512, 128), (500, 128), (33, 32), (64, 256)]
                         + [(m, d) for m in (1, 17, 500, 512, 513, 1024)
                            for d in (4, 12, 32, 128, 256)
                            if (m, d) not in ((512, 128), (500, 128))])
def test_dt_loss_kernel_matches_plain_on_card(cuda, M, D):
    """Ragged row and key edges (M = 1, 17, 500, 513), more than one key
    tile a CTA (M = 1024), D padded to the mma's k8 (4, 12); at three tau
    pairs; two calls bitwise equal."""
    rs = np.random.RandomState(M * 1000 + D)
    q = torch.from_numpy(_unit(rs, (M, D))).to(cuda)
    k = torch.from_numpy(_unit(rs, (M, D))).to(cuda)
    for ta, tb in DT_TAUS:
        before = dt_kernel.LAUNCHES
        got = ops.dt_loss_fwd(q, k, ta, tb)
        assert dt_kernel.LAUNCHES == before + 1
        for a, b in zip(got, ref.dt_loss_fwd_ref(q, k, ta, tb)):
            torch.testing.assert_close(a, b, atol=DT_FWD_TOL, rtol=0)
        again = ops.dt_loss_fwd(q, k, ta, tb)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    with pytest.raises(ValueError):
        ops.dt_loss_fwd(q.double(), k.double(), 0.1, 1.0)
    with pytest.raises(ValueError):                     # D % 4 != 0
        ops.dt_loss_fwd(q[:, :-2].contiguous(), k[:, :-2].contiguous(),
                        0.1, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("C,M,D", [(5, 512, 128), (3, 500, 128),
                                   (3, 513, 128), (1, 512, 128),
                                   (4, 17, 12), (2, 1024, 32)])
def test_dt_loss_cohort_kernel_matches_plain_on_card(cuda, C, M, D):
    """A cohort of C clients in ONE launch against the cohort plain
    version: ragged rows and keys at the client boundaries (M = 500, 513,
    17) read no other client's rows; each client's outputs are bitwise
    its own unbatched launch's; two calls bitwise equal."""
    rs = np.random.RandomState(C * 100000 + M * 1000 + D)
    q = torch.from_numpy(_unit(rs, (C, M, D))).to(cuda)
    k = torch.from_numpy(_unit(rs, (C, M, D))).to(cuda)
    for ta, tb in DT_TAUS:
        before = dt_kernel.LAUNCHES
        got = ops.dt_loss_fwd(q, k, ta, tb)
        assert dt_kernel.LAUNCHES == before + 1
        assert all(t.shape == (C, M) for t in got)
        for a, b in zip(got, ref.dt_loss_fwd_cohort_ref(q, k, ta, tb)):
            torch.testing.assert_close(a, b, atol=DT_FWD_TOL, rtol=0)
        again = ops.dt_loss_fwd(q, k, ta, tb)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        for c in range(C):
            one = ops.dt_loss_fwd(q[c].contiguous(), k[c].contiguous(), ta,
                                  tb)
            assert all(torch.equal(a, b[c]) for a, b in zip(one, got))


@pytest.mark.cuda
def test_dt_loss_vmapped_grads_match_the_loop_on_card(cuda):
    """`torch.func.vmap(torch.func.grad)` of the fused loss launches the
    cohort kernel once, and its gradients match a loop of the unbatched
    autograd path."""
    rs = np.random.RandomState(7)
    q = torch.from_numpy(_unit(rs, (3, 512, 128))).to(cuda)
    k = torch.from_numpy(_unit(rs, (3, 512, 128))).to(cuda)
    for ta, tb in DT_TAUS:
        def loss(a, b):
            return ops.dt_loss(a, b, ta, tb)

        before = dt_kernel.LAUNCHES
        gq, gk = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)))(q, k)
        assert dt_kernel.LAUNCHES == before + 1
        for c in range(3):
            qc = q[c].clone().requires_grad_()
            kc = k[c].clone().requires_grad_()
            a, b = torch.autograd.grad(loss(qc, kc), (qc, kc))
            torch.testing.assert_close(gq[c], a, atol=DT_GRAD_TOL, rtol=0)
            torch.testing.assert_close(gk[c], b, atol=DT_GRAD_TOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("tau", [0.1, 0.07, 0.2, 1.0])
def test_plain_scalar_division_is_reciprocal_multiply_on_card(cuda, tau):
    """The plain version's sim / tau on the card is sim times the float32
    reciprocal of tau, bitwise: the kernel's 1/tau multiply repeats it."""
    x = torch.randn((512, 512), generator=torch.Generator(device=cuda)
                    .manual_seed(3), device=cuda)
    inv = float(np.float32(1.0) / np.float32(tau))
    assert torch.equal(x / tau, x * inv)


@pytest.mark.cuda
def test_dt_loss_kernel_spills_nothing(cuda):
    """The kernel keeps its accumulators in registers (0 local bytes) at
    every width and launches clusters of 8 CTAs of 128 threads."""
    for d in (4, 128, 256):
        attrs = dt_kernel.kernel_attributes(d)
        assert attrs["local_bytes"] == 0, attrs
        assert attrs["cluster"] == 8 and attrs["threads"] == 128, attrs


@pytest.mark.cuda
@pytest.mark.parametrize("N,P", [(5, 4096), (1, 1001), (3, 70000)])
def test_q8_kernels_match_plain_on_card(cuda, N, P):
    """Codes, scales, new_ef and the decode bitwise equal to the plain
    versions (the kernels round each step once, as they do); a ragged P
    equals the aligned call's columns; a zero block decodes to zeros."""
    rs = np.random.RandomState(N * 31 + P)
    mag = 10.0 ** rs.uniform(-6, 2, size=(N, 1))
    x = torch.from_numpy((rs.randn(N, P) * mag).astype(np.float32)).to(cuda)
    e = torch.from_numpy((rs.randn(N, P) * mag * 0.01).astype(np.float32)
                         ).to(cuda)
    x[:, :256] = 0.0
    e[:, :256] = 0.0
    before = (q8_kernel.ENCODE_LAUNCHES, q8_kernel.DECODE_LAUNCHES)
    codes, scales, new_ef = ops.q8_encode_flat(x, e)
    out = ops.q8_decode_flat(codes, scales)
    assert (q8_kernel.ENCODE_LAUNCHES, q8_kernel.DECODE_LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
    pad = (-P) % q8_kernel.BQ
    xp = torch.nn.functional.pad(x, (0, pad))
    ep = torch.nn.functional.pad(e, (0, pad))
    c_r, s_r, e_r = ref.q8_encode_ref(xp, ep)
    assert torch.equal(codes, c_r[:, :P]) and torch.equal(scales, s_r)
    assert torch.equal(new_ef, e_r[:, :P])
    assert torch.equal(out, ref.q8_decode_ref(c_r, s_r)[:, :P])
    assert torch.equal(scales[:, 0], torch.zeros_like(scales[:, 0]))
    assert not out[:, :256].any()
    if pad:      # the aligned call on the padded matrix gives the same
        c_a, s_a, e_a = ops.q8_encode_flat(xp, ep)
        assert torch.equal(codes, c_a[:, :P]) and torch.equal(scales, s_a)
        assert torch.equal(new_ef, e_a[:, :P])
    with pytest.raises(ValueError):
        q8_kernel.q8_encode_cuda(x[:, 1:257].contiguous().double(),
                                 e[:, 1:257].contiguous().double())


def _rwkv6_inputs(rs, shape, dev):
    """r, k, v, logw as the reference's kernel tests draw them."""
    r, k, v = (torch.from_numpy((rs.randn(*shape) * 0.5).astype(np.float32))
               .to(dev) for _ in range(3))
    lw = np.clip(-np.exp(rs.randn(*shape) * 0.3 - 1.0), -4.0, -1e-4)
    return r, k, v, torch.from_numpy(lw.astype(np.float32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("BH,S,D,with_state", [
    (8, 128, 64, False), (5, 37, 32, True), (6, 253, 64, True),
    (3, 1, 64, True),
    # S on the slab edges: T - 1, T, T + 1, 2T + 1
    (4, RWKV6_SLAB - 1, 64, True), (4, RWKV6_SLAB, 64, False),
    (4, RWKV6_SLAB + 1, 32, True), (4, 2 * RWKV6_SLAB + 1, 64, True),
    (8, 2048, 64, False)])
def test_rwkv6_kernel_matches_plain_on_card(cuda, BH, S, D, with_state):
    """o and the state against the plain chunked version, per-row u; a
    ragged S's state against the sequential oracle."""
    rs = np.random.RandomState(BH * 1000 + S + D)
    r, k, v, lw = _rwkv6_inputs(rs, (BH, S, D), cuda)
    u = torch.from_numpy((rs.randn(BH, D) * 0.3).astype(np.float32)).to(cuda)
    s0 = (torch.from_numpy((rs.randn(BH, D, D) * 0.3).astype(np.float32))
          .to(cuda) if with_state else None)
    before = rwkv6_kernel.LAUNCHES
    o, st = ops.rwkv6(r, k, v, lw, u, s0)
    assert rwkv6_kernel.LAUNCHES == before + 1
    o_p, st_p = ref.rwkv6_chunked_ref(r, k, v, lw, u, s0)
    torch.testing.assert_close(o, o_p, atol=RWKV6_TOL, rtol=0)
    torch.testing.assert_close(st, st_p, atol=RWKV6_TOL, rtol=0)
    o_s, st_s = ref.rwkv6_ref(r, k, v, lw, u, s0)
    torch.testing.assert_close(o, o_s, atol=RWKV6_TOL, rtol=0)
    torch.testing.assert_close(st, st_s, atol=RWKV6_TOL, rtol=0)


@pytest.mark.cuda
def test_rwkv6_kernel_reads_bshd_in_place(cuda):
    """The (B, S, H, D) layout, read by strides, gives bitwise the (BH, S,
    D) call on the transposed copies (same arithmetic, other addresses)."""
    B, S, H, D = 2, 45, 3, 64
    rs = np.random.RandomState(4)
    r, k, v, lw = _rwkv6_inputs(rs, (B, S, H * D), cuda)
    u = torch.from_numpy((rs.randn(H, D) * 0.3).astype(np.float32)).to(cuda)
    s0 = torch.from_numpy((rs.randn(B, H, D, D) * 0.3).astype(np.float32)
                          ).to(cuda)
    four = [t.view(B, S, H, D) for t in (r, k, v, lw)]
    o4, st4 = ops.rwkv6(*four, u, s0)
    rows = [t.transpose(1, 2).reshape(B * H, S, D) for t in four]
    o3, st3 = ops.rwkv6(*rows, u.repeat(B, 1), s0.reshape(B * H, D, D))
    assert o4.shape == (B, S, H, D) and st4.shape == (B, H, D, D)
    assert torch.equal(o4.transpose(1, 2).reshape(B * H, S, D), o3)
    assert torch.equal(st4.reshape(B * H, D, D), st3)
    with pytest.raises(ValueError):                     # D not 32 or 64
        ops.rwkv6(*(t[..., :48] for t in rows), u[0, :48])
    with pytest.raises(ValueError):
        ops.rwkv6(*(t.double() for t in rows), u[0].double())


@pytest.mark.cuda
def test_rwkv6_kernel_fits_one_wave(cuda):
    """The D = 64 instance spills nothing and fits at least four blocks an
    SM, so the full-width prefill's 512 rows run in one wave on 132 SMs;
    the D = 32 instance spills nothing either."""
    attrs = rwkv6_kernel.kernel_attributes(64)
    assert attrs["local_bytes"] == 0 and attrs["blocks_per_sm"] >= 4, attrs
    assert attrs["steps_per_slab"] == RWKV6_SLAB and attrs["threads"] == 64
    assert rwkv6_kernel.kernel_attributes(32)["local_bytes"] == 0


# --------------------------------------------------------------------------
# the differentiable rwkv6 and the DT kernel's wide form (the zoo's train
# step; their CPU parity tests live in tests/test_torch_train.py)
# --------------------------------------------------------------------------

def _leaf_rel(a, b) -> float:
    """max |a - b| over max |b|, in float64."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


# the Function's gradients against autograd through the plain chunk loop:
# the chunk states summed all at once against one by one (float32)
RWKV6_GRAD_REL = 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("BH,S,with_state", [(8, 300, True),
                                             (32, 512, False)])
def test_rwkv6_function_on_card_matches_plain_gradients(cuda, BH, S,
                                                        with_state):
    """`ops.rwkv6` with inputs that require gradients: the forward
    launches the kernel once, and the gradients of r, k, v, logw, u (and
    state0) match autograd through `rwkv6_plain` on the card."""
    rs = np.random.RandomState(BH + S)
    D = 64
    r, k, v, lw = _rwkv6_inputs(rs, (BH, S, D), cuda)
    leaves = [r, k, v, lw,
              torch.from_numpy((rs.randn(BH, D) * 0.3).astype(np.float32))
              .to(cuda)]
    if with_state:
        leaves.append(torch.from_numpy(
            (rs.randn(BH, D, D) * 0.3).astype(np.float32)).to(cuda))
    leaves = [t.requires_grad_() for t in leaves]
    go = torch.from_numpy(rs.randn(BH, S, D).astype(np.float32)).to(cuda)
    gs = torch.from_numpy(rs.randn(BH, D, D).astype(np.float32)).to(cuda)

    def grads(fn):
        o, st = fn(*leaves, *([None] * (6 - len(leaves))))
        return torch.autograd.grad((o * go).sum() + (st * gs).sum(), leaves)

    before = rwkv6_kernel.LAUNCHES
    got = grads(ops.rwkv6)
    assert rwkv6_kernel.LAUNCHES == before + 1
    want = grads(ops.rwkv6_plain)
    assert rwkv6_kernel.LAUNCHES == before + 1
    for g, w in zip(got, want):
        assert _leaf_rel(g, w) <= RWKV6_GRAD_REL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 2048), (2, 8, 2048), (512, 2048),
                                   (37, 260), (3, 17, 1024), (8, 8192),
                                   (3, 17, 4608), (8, 1600), (512, 1600),
                                   (8, 1024), (512, 1024),
                                   # the published micro-batches
                                   (16, 896), (16, 1024), (2, 4608),
                                   (1, 7168), (1, 8192), (5, 8, 2048)])
def test_dt_loss_wide_kernel_matches_plain_on_card(cuda, shape):
    """The wide form (256 < D <= 8192) against the plain version on unit
    rows: one launch of it and none of the narrow kernel, two calls
    bitwise equal; D % 4 != 0 and D above 8192 refused. The ranks split
    D at M <= 64 and the keys above (37 rows: two clusters of the D
    split; 512: 16 clusters of the key split)."""
    rs = np.random.RandomState(sum(shape))
    q = torch.from_numpy(_unit(rs, shape)).to(cuda)
    k = torch.from_numpy(_unit(rs, shape)).to(cuda)
    narrow, wide = dt_kernel.LAUNCHES, dt_kernel.WIDE_LAUNCHES
    got = ops.dt_loss_fwd(q, k, 0.1, 1.0)
    assert (dt_kernel.LAUNCHES, dt_kernel.WIDE_LAUNCHES) == (narrow,
                                                             wide + 1)
    plain = (ref.dt_loss_fwd_cohort_ref if q.dim() == 3
             else ref.dt_loss_fwd_ref)(q, k, 0.1, 1.0)
    for a, b in zip(got, plain):
        torch.testing.assert_close(a, b, atol=DT_FWD_TOL, rtol=0)
    again = ops.dt_loss_fwd(q, k, 0.1, 1.0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    with pytest.raises(ValueError):
        ops.dt_loss_fwd(q[..., :-2].contiguous(), k[..., :-2].contiguous(),
                        0.1, 1.0)
    big = torch.zeros((*shape[:-1], 8196), device=cuda)
    with pytest.raises(ValueError, match="dt_loss kernel takes D"):
        ops.dt_loss_fwd(big, big, 0.1, 1.0)


@pytest.mark.cuda
def test_dt_loss_wide_kernel_spills_nothing(cuda):
    """The wide form keeps its accumulators and states in registers (0
    local bytes) at the zoo's widths, and launches clusters of 8 CTAs of
    8 consumer warps and a producer that an SM can hold."""
    for d in (1024, 4608, 8192):
        attrs = dt_kernel.wide_kernel_attributes(d)
        assert attrs["local_bytes"] == 0, attrs
        assert attrs["cluster"] == WIDE_CLUSTER, attrs
        assert attrs["threads"] == 32 * (WIDE_WARPS + 1), attrs
        assert attrs["blocks_per_sm"] >= 1, attrs


@pytest.mark.cuda
@pytest.mark.parametrize("factor", [1.0, 16.0])
def test_moe_block_on_card_matches_cpu(cuda, factor):
    """`layers.moe_block` (plain torch and cuBLAS, no kernel of its own) on
    the card against the CPU, float32 with TF32 off, olmoe's smoke config
    with its shared expert added: top-k indices and the drop masks equal
    (a near tie within float32 rounding would flip one; none at these
    inputs), outputs and the aux loss within 2e-5; and one block on the
    card makes no host sync."""
    import dataclasses

    from repro_torch.analysis.guards import no_implicit_transfers
    from repro_torch.configs import get_config
    from repro_torch.convert import tree_map
    from repro_torch.models import layers as L
    from repro_torch.runtime import set_parity_mode

    set_parity_mode()
    cfg = dataclasses.replace(get_config("olmoe-1b-7b-smoke"),
                              moe_capacity_factor=factor, n_shared_experts=1)
    p = L.init_moe(cfg, torch.Generator().manual_seed(0))
    x = torch.randn((2, 64, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    outs = []
    for dev in (cuda, torch.device("cpu")):
        pd, xd = tree_map(lambda t: t.to(dev), p), x.to(dev)
        logits = xd.reshape(-1, cfg.d_model) @ pd["router"]
        _, _, idx = L.moe_route(cfg, logits)
        _, _, _, valid = L.moe_slots(cfg, idx, L.moe_capacity(cfg, 128))
        y, aux = L.moe_block(cfg, pd, xd)
        outs.append([t.cpu() for t in (idx, valid, y, aux)])
    (ic, vc, yc, ac), (ih, vh, yh, ah) = outs
    assert torch.equal(ic, ih) and torch.equal(vc, vh)
    assert bool((~vh).any()) == (factor == 1.0)
    torch.testing.assert_close(yc, yh, atol=2e-5, rtol=0)
    torch.testing.assert_close(ac, ah, atol=2e-5, rtol=0)
    pd, xd = tree_map(lambda t: t.to(cuda), p), x.to(cuda)
    torch.cuda.synchronize()
    with no_implicit_transfers():
        L.moe_block(cfg, pd, xd)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_ssm_block_on_card_matches_cpu(cuda):
    """`layers.ssm_block` (plain torch and cuBLAS) on the card against the
    CPU, float32 with TF32 off, hymba's smoke config: 200 tokens (a
    128-chunk and a ragged 72) from given SSM and conv states, the
    output and both states within 2e-4, the gradients through the
    recomputing backward within 2e-5 of each one's max; a decode step
    on the card makes no host sync."""
    from repro_torch.analysis.guards import no_implicit_transfers
    from repro_torch.configs import get_config
    from repro_torch.convert import leaves_with_paths, unflatten
    from repro_torch.models import layers as L
    from repro_torch.runtime import set_parity_mode

    set_parity_mode()
    cfg = get_config("hymba-1.5b-smoke")
    di = cfg.ssm_expand * cfg.d_model
    gen = torch.Generator().manual_seed(0)
    p = L.init_ssm(cfg, gen)
    ins = [torch.randn(shape, generator=gen) * scale
           for shape, scale in (((2, 200, cfg.d_model), 0.5),
                                ((2, di, cfg.ssm_state), 0.1),
                                ((2, 3, di), 0.5))]
    gs = [torch.randn(t.shape, generator=gen) for t in ins]
    outs = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.to(dev).requires_grad_() for _, t in leaves_with_paths(p)]
        x, h0, c0 = (t.to(dev).requires_grad_() for t in ins)
        o, (h, c) = L.ssm_block(cfg, unflatten(leaves, p), x, h0, c0)
        loss = sum((a * w.to(dev)).sum() for a, w in zip((o, h, c), gs))
        grads = torch.autograd.grad(loss, leaves + [x, h0])
        outs.append(([t.detach().cpu() for t in (o, h, c)],
                     [t.cpu() for t in grads]))
    (vc, gc), (vh, gh) = outs
    for a, b in zip(vc, vh):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=0)
    for a, b in zip(gc, gh):
        assert float((a - b).abs().max() / b.abs().max()) <= 2e-5
    pc = {k: v.to(cuda) for k, v in p.items()}
    step_in = [t[:, :1].to(cuda) if i == 0 else t.to(cuda)
               for i, t in enumerate(ins)]
    torch.cuda.synchronize()
    with no_implicit_transfers():
        L.ssm_step(cfg, pc, *step_in)
    torch.cuda.synchronize()
