"""Neural-net primitives of the zoo's ``dense``, ``moe``, ``ssm``
(RWKV6 "Finch"), ``hybrid`` (Hymba) and ``audio`` (SeamlessM4T)
families — counterpart of
`repro.models.layers`
(`normal_init`, `fan_in_init`, the norms, `act_fn`, `rope_freqs`,
`apply_rope`, `_softcap`, `_build_mask`, `_attn_direct`,
`flash_attention` with its custom VJP, `attention_core`,
`init_attention`, `attention_block`, `make_cache`, `_quantize_kv`,
`_dequantize_kv`, `init_mlp`, `mlp_block`, `init_moe`, `moe_block`,
`_moe_dispatch_local`, `moe_block_ep`, `moe_apply`,
`moe_block_dense_ref`,
`init_rwkv_tmix`, `_rwkv_project`, `rwkv_tmix_chunked`, `rwkv_tmix_step`,
`init_rwkv_cmix`, `rwkv_cmix`, `init_ssm`, `_ssm_conv`, `ssm_block`,
`ssm_step`).

Functional, like the reference: ``init_*`` builds a dict of tensors from
an explicit `torch.Generator` (the tensors land on the generator's
device), the matching apply function consumes it. Weight layouts are the
reference's: ``x @ W`` with W as (d_in, d_out). Numerics follow it too:
parameters in the caller's dtype except the float32 decay and bonus
leaves (``w0``, ``w_lora_b``, ``u``), norm statistics, token-shift mixes
and the recurrence in float32, each projection's output in the input's
dtype.

Attention is plain torch and cuBLAS, as the reference's is jnp (no
Pallas kernel): GQA with q viewed as (B, S, KH, G, D), so head h =
kh * G + g reads kv head kh; scores, softmax and the probability-value
products in float32, masked scores at the finite NEG_INF.
Self-attention is causal with RoPE, or non-causal (the audio
encoder's); cross-attention projects k and v from a context and lets
every query see all of it, without RoPE, on the same two paths. The
flash path is a `torch.autograd.Function` over key chunks whose backward
recomputes the chunk tiles, so training at S = 4096 never keeps a
(Sq, Sk) tile per layer. KV caches are ring buffers (position t in slot
t % W) in the parameters' dtype, float32 or int8 with per-(slot, head)
scales.

The chunked time-mix runs the hand-written kernel through
`kernels.ops.rwkv6` (the plain chunked version on the CPU): once per
layer on the whole sequence, from the cache's state, reading the
projections' (B, S, H, D) layout in place. The kernel takes any S, so a
ragged S needs no head/tail split. The one-token decode step is plain
torch, as the reference's is jnp.

The MoE block is the reference's sort-based capacity dispatch in plain
torch and cuBLAS, as the reference's is jnp: float32 router, softmax and
top-k, a stable argsort of the assignments' expert ids, each kept
assignment scattered into its expert's slot of an (E, C + 1, d) buffer
whose last slot takes every dropped one (and is cut off), the expert
products as batched matmuls, then gather, unsort and the gate-weighted
sum. Every size comes from shapes, so a block makes no host sync.

On a mesh (the zoo's mesh steps, launch/steps.py) the same functions
take DTensors, and DTensor's sharding propagation carries the products,
norms and elementwise ops. The `constrain` hooks (models/
sharding_hooks.py) sit at the reference's sites: ``attn_bshd`` on q,
``cache_kv`` on the written rings, ``tokens_bsf`` on the MLP hidden,
``moe_ecd`` on the capacity buffer. Where DTensor has no strategy, or
one that cannot serve, the op's inputs are placed by hand, at the op,
as GSPMD places the reference's:
- `_whole_on`: a head shard that does not cover whole kv groups is
  replicated before the head split and the GQA view;
- `attention_core` (`_local_attention`): each rank attends on its
  (batch, head) shards, a W-sharded cache gathered (the flash Function
  allocates plain tiles; the direct path's 5-D products cost DTensor
  seconds of strategy search a shape);
- `_ring_put`: the cache writes are local `index_put`s (no strategy for
  index tensors), each rank its rows and, on a W shard, its slots;
- `moe_block`: the dispatch (argsort, `searchsorted`, the scatter,
  gather and unsort) on the tokens and router logits replicated over
  the batch (no `searchsorted` strategy; the reference's global argsort
  is replicated by GSPMD too), the expert products on the DTensors;
- `moe_block_ep`: the `shard_map` counterpart on local shards, with
  its own differentiable all_to_all and all-reduce;
- `attention_block`'s output projection is one 2-D product (a decode
  step's (B, 1, H hd) DTensor view can carry a stride that sends
  `matmul` to `bmm`, off the one-device step's bits);
- `rwkv_tmix_chunked` and `rwkv_tmix_step` (`rwkv6_on_shards`): the
  rwkv6 kernel, and the decode step's recurrence (DTensor cannot
  flatten its einsum over the (B, H, D, D) state), on each rank's
  (batch, head) shards (the recurrence is independent per sequence and
  head, so no collective): r, k, v and the log-decay on the tokens'
  batch placement and, where ``model`` divides the heads, d on
  ``model`` (wr/wk/wv's and w_lora_b's layout), u's local heads sliced
  from the replicated leaf, the carried state as the cache's (bax,
  "model") shard; `ops.rwkv6` raises for a DTensor;
- `ssm_block` (`_ssm_scan_on_shards`): x1 and z placed on di over
  ``model`` at the split of w_in's output (conv's, A_log's and D's
  layout); the scan (`_SSMScan`, its recomputing backward too) on each
  rank's (batch, di) shards, with B and C reduced to replicated over
  ``model`` first (w_B and w_C are ("model", None), so x1 @ w_B comes
  out partial, as GSPMD reduces it), a_mat's local rows and the
  state's (bax, "model") shard, or zeros made as that shard; the
  conv's zero pad made as a shard of its input;
- cross attention: the context's key positions take the queries'
  batch placement (`_local_attention` then attends Sq queries over the
  Sk context rows on each rank's shards).
Constants the functions make (rotary frequencies) are replicated over
the mesh (`replicated_like`), as GSPMD replicates a constant. An input
that a local op reads whole on a mesh dim its work is split over (u
on a head split, B and C on a di split, a_mat on a batch split) has its
gradient declared partial there (`_work_grads`): each rank adds its
share. A local result re-enters DTensor contiguous (`local_to_mesh`),
and so does the gradient of a local input (`mesh_to_local`): DTensor's
views assume the layout its strides claim, and a local product's
gradient is often a transposed view.

The selective SSM (Hymba's parallel branch) is plain torch, as the
reference's is jnp: projections in the weights' dtype, the width-4 conv,
dt, B, C and the recurrence in float32. The reference walks its chunks
of SSM_CHUNK steps with `lax.scan` and scans each chunk with
`lax.associative_scan`; the port mirrors that recursion over strided
slices, in the same association order, scans a group of chunks at once
(the within-chunk scan reads no state) and passes the state from chunk
to chunk. `_SSMScan` saves the inputs and each group's starting state,
and its backward recomputes the group.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.sharding_hooks import (constrain, contiguous_grad,
                                               is_dtensor, local_to_mesh,
                                               mesh_to_local, replicated_like,
                                               sharded_like)

NEG_INF = -1e30
BIG_WINDOW = 1 << 30  # "no sliding window"
RWKV_DECAY_FLOOR = -4.0  # clamp of the per-step log-decay, as the reference


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------

def normal_init(gen: torch.Generator, shape, std, dtype=torch.float32):
    """float32 N(0, std^2) draws on the generator's device, cast to dtype."""
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * std).to(dtype)


def fan_in_init(gen: torch.Generator, shape, dtype=torch.float32):
    """N(0, 1 / fan_in) with fan_in = shape[0]."""
    return normal_init(gen, shape, 1.0 / math.sqrt(shape[0]), dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def init_rmsnorm(d, dtype=torch.float32, device=None):
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps=1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].float())).to(x.dtype)


def init_layernorm(d, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p, x, eps=1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def init_norm(cfg, d=None, dtype=torch.float32, device=None):
    d = d or cfg.d_model
    if cfg.norm == "rmsnorm":
        return init_rmsnorm(d, dtype, device)
    return init_layernorm(d, dtype, device)


def apply_norm(cfg, p, x):
    fn = rmsnorm if "bias" not in p else layernorm
    return fn(p, x, cfg.norm_eps)


# --------------------------------------------------------------------------
# activations
# --------------------------------------------------------------------------

def act_fn(name: str):
    """The MLP activations of the dense configs, as the reference's; its
    gelu is the tanh approximation."""
    return {"silu": F.silu,
            "gelu": functools.partial(F.gelu, approximate="tanh")}[name]


# --------------------------------------------------------------------------
# rotary position embedding
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S). Rotates
    the two halves of D (not interleaved pairs), in float32."""
    inv = replicated_like(rope_freqs(x.shape[-1], theta, x.device),
                          positions)                          # (D/2,)
    ang = positions[..., None].float() * inv                  # (..., S, D/2)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention core — direct and kv-chunked (flash-style) paths
# --------------------------------------------------------------------------

def _softcap(s, cap):
    return cap * torch.tanh(s / cap) if cap else s


def _build_mask(q_pos, kv_pos, *, causal, window):
    """(B, Sq, Sk) boolean visibility mask. q_pos: (B, Sq); kv_pos:
    (B, Sk), where kv_pos < 0 marks an empty cache slot; BIG_WINDOW
    disables the window."""
    d = q_pos[..., :, None] - kv_pos[..., None, :]
    mask = kv_pos[..., None, :] >= 0
    if causal:
        mask = mask & (d >= 0)
    return mask & (d < window)


def _attn_direct(q, k, v, mask, *, scale, softcap):
    """q: (B,Sq,KH,G,D)  k,v: (B,Sk,KH,D)  mask: (B,Sq,Sk) ->
    (B,Sq,KH,G,D) in q's dtype. Scores, softmax and both products in
    float32; the probabilities rounded to v's dtype first, as the
    reference's."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())
    s = _softcap(s * scale, softcap)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


FLASH_MIN_SQ = 2048   # the flash path at and above this many queries
FLASH_CHUNK = 1024    # keys a chunk of the flash path


def _flash_rows(t):
    """(B, S, KH, G, D) -> (B, KH, G * S, D) float32: a query tile's rows
    in (g, s) order, so a chunk's scores are one batched product."""
    b, s, kh, g, d = t.shape
    return t.float().permute(0, 2, 3, 1, 4).reshape(b, kh, g * s, d)


def _flash_chunk(k, q_pos, kv_pos, c0, chunk, causal, window):
    """Key chunk [c0, c0 + chunk) as (B, KH, C, D) float32, and where its
    (B, 1, 1, Sq, C) scores are masked."""
    kc = k[:, c0:c0 + chunk].float().permute(0, 2, 1, 3)
    mask = _build_mask(q_pos, kv_pos[:, c0:c0 + chunk], causal=causal,
                       window=window)
    return kc, ~mask[:, None, None]


class _FlashAttention(torch.autograd.Function):
    """`flash_attention` with its custom VJP (`_flash_fwd_scan`,
    `_flash_fwd`, `_flash_bwd`): the forward walks FLASH_CHUNK-wide key
    chunks in float32 with an online softmax and saves only (q, k, v, o,
    lse); the backward recomputes each chunk's score tile (the softcap's
    1 - tanh^2 factor included). A tile is (B, KH, G * Sq, C) float32,
    updated in place, so the forward holds one and the backward at most
    three at a time. Masked scores are NEG_INF and their probabilities
    0, so a fully masked row comes out as zeros."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, window, causal, scale, softcap,
                chunk):
        b, sq, kh, g, d = q.shape
        qf = _flash_rows(q)
        m = torch.full((b, kh, g * sq), NEG_INF, device=q.device)
        l_ = torch.zeros((b, kh, g * sq), device=q.device)
        acc = torch.zeros((b, kh, g * sq, d), device=q.device)
        for c0 in range(0, k.shape[1], chunk):
            kc, dead = _flash_chunk(k, q_pos, kv_pos, c0, chunk, causal,
                                    window)
            s = (qf @ kc.transpose(-1, -2)).mul_(scale)
            if softcap:
                s.div_(softcap).tanh_().mul_(softcap)
            s5 = s.view(b, kh, g, sq, -1).masked_fill_(dead, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            s.sub_(m_new[..., None]).exp_()
            s5.masked_fill_(dead, 0.0)                     # p
            vc = v[:, c0:c0 + chunk].float().permute(0, 2, 1, 3)
            l_ = l_ * alpha + s.sum(dim=-1)
            acc = acc * alpha[..., None] + s @ vc
            m = m_new
            del s, s5
        l_safe = torch.clamp(l_, min=1e-20)
        o = acc / l_safe[..., None]                        # (B,KH,G*Sq,D)
        lse = m + torch.log(l_safe)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, o, lse)
        ctx.args = (window, causal, scale, softcap, chunk)
        return o.view(b, kh, g, sq, d).permute(0, 3, 1, 2, 4).to(q.dtype)

    @staticmethod
    def backward(ctx, g_out):
        q, k, v, q_pos, kv_pos, o, lse = ctx.saved_tensors
        window, causal, scale, softcap, chunk = ctx.args
        b, sq, kh, g, d = q.shape
        qf = _flash_rows(q)
        do = _flash_rows(g_out)
        delta = (do * o).sum(dim=-1)
        dq = torch.zeros_like(qf)
        dk = torch.empty((b, k.shape[1], kh, d), device=q.device)
        dv = torch.empty_like(dk)
        for c0 in range(0, k.shape[1], chunk):
            kc, dead = _flash_chunk(k, q_pos, kv_pos, c0, chunk, causal,
                                    window)
            vc = v[:, c0:c0 + chunk].float().permute(0, 2, 1, 3)
            s = (qf @ kc.transpose(-1, -2)).mul_(scale)      # s_raw
            t = None
            if softcap:
                t = s.div_(softcap).tanh_()                  # tanh(s_raw / cap)
                s = t * softcap
            p = s.sub_(lse[..., None]).exp_()
            p.view(b, kh, g, sq, -1).masked_fill_(dead, 0.0)
            dv[:, c0:c0 + chunk] = (p.transpose(-1, -2) @ do).transpose(1, 2)
            ds = (do @ vc.transpose(-1, -2)).sub_(delta[..., None]).mul_(p)
            del p, s
            if softcap:
                ds.mul_(t.square_().neg_().add_(1.0))
                del t
            ds.mul_(scale)
            dq += ds @ kc
            dk[:, c0:c0 + chunk] = (ds.transpose(-1, -2) @ qf).transpose(1, 2)
            del ds
        dq = dq.view(b, kh, g, sq, d).permute(0, 3, 1, 2, 4)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None, None, None)


def flash_attention(qg, k, v, q_pos, kv_pos, window, causal, scale, softcap,
                    chunk=FLASH_CHUNK):
    """qg: (B,Sq,KH,G,D); k/v: (B,Sk,KH,D), Sk a multiple of `chunk`;
    positions (B, Sq) and (B, Sk). Returns (B,Sq,KH,G,D) in qg's dtype,
    differentiable in qg, k and v."""
    return _FlashAttention.apply(qg, k, v, q_pos, kv_pos, window, causal,
                                 scale, softcap, chunk)


def _whole_on(t, dim: int, n: int):
    """A DTensor `t` with dim `dim` replicated where the mesh dims that
    shard it do not divide `n`, the outer size `dim` is about to be
    split into (a reshape of n * m into (n, m) keeps a shard only if
    it covers whole rows of n: the reshard GSPMD inserts for the
    reference's reshapes); any other `t` as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    mesh, pl = t.device_mesh, tuple(t.placements)
    k = math.prod(mesh.size(i) for i, p in enumerate(pl) if p == Shard(dim))
    if n % k == 0:
        return t
    return t.redistribute(mesh, [Replicate() if p == Shard(dim) else p
                                 for p in pl])


def _local_attention(q, k, v, q_pos, kv_pos, **kw):
    """`attention_core` on DTensors, run on each rank's shards: each rank
    takes its batch rows and heads (q's batch and head placements; k, v
    the same, a cache's W shard gathered, and the positions the
    batch's), attends alone as each (batch, head) shard does under
    GSPMD's ``attn_bshd`` layout, and the output keeps q's placements.
    The flash Function allocates its tiles as plain tensors, and
    DTensor's strategy search for the direct path's 5-D products takes
    seconds a shape."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    pl = [p if p in (Shard(0), Shard(2)) else Replicate()
          for p in q.placements]
    pos_pl = [p if p == Shard(0) else Replicate() for p in pl]
    ql, kl, vl = (mesh_to_local(t, pl) for t in (q, k, v))
    qp, kp = (mesh_to_local(t, pos_pl) for t in (q_pos, kv_pos))
    o = attention_core(ql, kl, vl, qp, kp, **kw)
    return local_to_mesh(o, mesh, pl, q.shape)


def attention_core(q, k, v, q_pos, kv_pos, *, causal=True, window=None,
                   scale=None, softcap=0.0):
    """GQA attention. q: (B,Sq,H,D) -> (B,Sq,H,D); k/v: (B,Sk,KH,D); head
    h reads kv head h // (H / KH). Sq >= FLASH_MIN_SQ with Sk a multiple
    of FLASH_CHUNK takes the flash path, otherwise the direct one (decode
    steps, short sequences), as the reference's. On DTensors each rank
    attends on its shards (`_local_attention`)."""
    if is_dtensor(q):          # heads whole for the GQA view's (KH, G)
        return _local_attention(_whole_on(q, 2, k.shape[2]), k, v, q_pos,
                                kv_pos, causal=causal, window=window,
                                scale=scale, softcap=softcap)
    # q's, k's and v's gradients leave contiguous, as they leave
    # `_local_attention` on a mesh (`mesh_to_local`), so the products
    # behind them take the same layouts on one device and on a mesh: a
    # one-row batch's k gradient is otherwise a strided view, which the
    # card's cuBLAS sums in another order
    q, k, v = (contiguous_grad(t) for t in (q, k, v))
    if window is None:
        window = BIG_WINDOW
    b, sq, h, d = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, sq, kh, h // kh, d)
    scale = scale if scale else 1.0 / math.sqrt(d)
    if sq >= FLASH_MIN_SQ and k.shape[1] % FLASH_CHUNK == 0:
        o = flash_attention(qg, k, v, q_pos, kv_pos, window, causal, scale,
                            softcap)
    else:
        mask = _build_mask(q_pos, kv_pos, causal=causal, window=window)
        o = _attn_direct(qg, k, v, mask, scale=scale, softcap=softcap)
    return o.reshape(b, sq, h, d)


# --------------------------------------------------------------------------
# attention block (projections + rope + ring-buffer cache)
# --------------------------------------------------------------------------

def init_attention(cfg, gen: torch.Generator, dtype=torch.float32,
                   cross: bool = False):
    """q, k, v, o projections (and qwen2's q, k, v biases, which a
    `cross` block never has, as the reference's)."""
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    p = {"wq": fan_in_init(gen, (d, h * hd), dtype),
         "wk": fan_in_init(gen, (d, kh * hd), dtype),
         "wv": fan_in_init(gen, (d, kh * hd), dtype),
         "wo": fan_in_init(gen, (h * hd, d), dtype)}
    if cfg.qkv_bias and not cross:
        for name, n in (("bq", h), ("bk", kh), ("bv", kh)):
            p[name] = torch.zeros((n * hd,), dtype=dtype, device=gen.device)
    return p


def attention_block(cfg, p, x, q_pos, *, causal=True, window=None,
                    cache=None, kv_src=None, use_rope=True):
    """Self-attention with RoPE and an optional ring-buffer cache, or
    cross-attention over a context.

    x: (B, Sq, d); q_pos: (B, Sq) absolute positions, consecutive along a
    row. Self-attention is causal unless `causal` is False (the
    encoder's). cache: None, or ``{"k", "v": (B, W, KH, hd), "pos": (B,
    W) int32}`` (plus ``"k_scale"``, ``"v_scale"`` (B, W, KH) float32
    when k and v are int8). Position t goes to slot t % W and the
    queries attend over the updated buffer. A prefill longer than the
    ring writes its last W positions only: the reference's scatter keeps
    the latest of the positions that share a slot, and a scatter with
    repeated indices on the card promises no order.

    kv_src: a context (B, Sk, d) to attend over instead (the encoder's
    output): k and v are projected from it, nothing is rotated, and
    every query sees every context row (the reference's query positions
    1 against key positions 0, non-causal, no window); the cache is
    neither read nor written; its k and v projections run in the
    profiler range ``attention.ctx_kv``. Without it, RoPE rotates q and
    k at `q_pos` when `use_rope` is set. Returns (out (B, Sq, d), the
    new cache or None); the cache passed in is not changed."""
    b, sq, _ = x.shape
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    sk = x.shape[1] if kv_src is None else kv_src.shape[1]
    q = x @ p["wq"]
    if kv_src is None:
        k, v = x @ p["wk"], x @ p["wv"]
    else:
        with torch.profiler.record_function("attention.ctx_kv"):
            k, v = kv_src @ p["wk"], kv_src @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = constrain(_whole_on(q, 2, h).reshape(b, sq, h, hd), "attn_bshd")
    k = _whole_on(k, 2, kh).reshape(b, sk, kh, hd)
    v = _whole_on(v, 2, kh).reshape(b, sk, kh, hd)
    if use_rope and kv_src is None:
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, q_pos, cfg.rope_theta)
    kw = dict(scale=cfg.attn_scale_override or None,
              softcap=cfg.attn_logit_softcap)
    if kv_src is not None:     # on a mesh: the queries' batch placement
        kv_pos = sharded_like(torch.zeros((b, sk), dtype=q_pos.dtype,
                                          device=x.device), q_pos)
        o = attention_core(q, k, v, torch.ones_like(q_pos), kv_pos,
                           causal=False, **kw)
        new_cache = None
    elif cache is None:
        o = attention_core(q, k, v, q_pos, q_pos, causal=causal,
                           window=window, **kw)
        new_cache = None
    else:
        w = cache["k"].shape[1]
        pos_w, k_w, v_w = q_pos[:, -w:], k[:, -w:], v[:, -w:]
        new_cache = {"pos": _ring_put(cache["pos"], pos_w,
                                     pos_w.to(cache["pos"].dtype))}
        if cache["k"].dtype == torch.int8:
            for name, t in (("k", k_w), ("v", v_w)):
                codes, scale = _quantize_kv(t)
                new_cache[name] = constrain(_ring_put(cache[name], pos_w,
                                                     codes), "cache_kv")
                new_cache[f"{name}_scale"] = _ring_put(
                    cache[f"{name}_scale"], pos_w, scale)
            k_use = _dequantize_kv(new_cache["k"], new_cache["k_scale"],
                                   k.dtype)
            v_use = _dequantize_kv(new_cache["v"], new_cache["v_scale"],
                                   v.dtype)
        else:
            for name, t in (("k", k_w), ("v", v_w)):
                new_cache[name] = constrain(_ring_put(
                    cache[name], pos_w, t.to(cache[name].dtype)),
                    "cache_kv")
            k_use, v_use = new_cache["k"], new_cache["v"]
        o = attention_core(q, k_use, v_use, q_pos, new_cache["pos"],
                           causal=causal, window=window, **kw)
    # one (B Sq, H hd) product, the fold plain `matmul` makes; under
    # DTensor a decode step's (B, 1, H hd) view can carry a non-canonical
    # stride on its size-1 dim, and `matmul` would then take `bmm`
    out = (o.reshape(b * sq, h * hd) @ p["wo"]).reshape(b, sq, -1)
    return out, new_cache


def _ring_put(buf, pos, vals):
    """`buf` (B, W, ...) with row b's values `vals[b, j]` written at slot
    pos[b, j] % W (`pos` (B, Sw), Sw <= W, so no slot is written twice):
    a new tensor, `buf` unchanged.

    On a mesh (a DTensor `buf`) the write is local, since DTensor has no
    strategy for `index_put` with index tensors: `vals` and `pos` take
    `buf`'s batch placement (and its head or head_dim one), each rank
    writes its rows into its own slice, and where `buf` shards W over a
    mesh dim each rank keeps the positions that fall in its slots
    (the others go to an overflow slot that is cut off). The result has
    `buf`'s placements, as GSPMD keeps a cache in its layout."""
    if not is_dtensor(buf):
        at = (torch.arange(buf.shape[0], device=buf.device)[:, None],
              pos % buf.shape[1])
        return buf.index_put(at, vals)
    from torch.distributed.tensor import Replicate, Shard
    mesh, pl = buf.device_mesh, tuple(buf.placements)
    w = buf.shape[1]
    # vals and pos: buf's placements, with W's replaced by Replicate (the
    # written positions are not W-aligned); pos has no dims past 1
    v_pl = [Replicate() if p == Shard(1) else p for p in pl]
    p_pl = [p if p == Shard(0) else Replicate() for p in pl]
    vl = vals.redistribute(mesh, v_pl).to_local()
    slot = pos.redistribute(mesh, p_pl).to_local() % w
    bl = buf.to_local()
    rows = torch.arange(bl.shape[0], device=bl.device)[:, None]
    w_dims = [i for i, p in enumerate(pl) if p == Shard(1)]
    if not w_dims:
        out = bl.index_put((rows, slot), vl)
    else:
        wl = bl.shape[1]
        w0 = 0
        for i in w_dims:                      # the major W split first
            w0 = w0 * mesh.size(i) + mesh.get_local_rank(i)
        slot = slot - w0 * wl
        keep = (slot >= 0) & (slot < wl)
        slot = torch.where(keep, slot, wl)
        ext = torch.cat([bl, bl.new_zeros((bl.shape[0], 1)
                                          + tuple(bl.shape[2:]))], dim=1)
        out = ext.index_put((rows, slot), vl)[:, :wl]
    return local_to_mesh(out, mesh, pl, buf.shape)


def make_cache(cfg, batch: int, width: int, dtype=torch.bfloat16,
               n_layers=None, device=None) -> dict:
    """Empty ring-buffer cache for `n_layers` stacked layers (0: one
    unstacked layer): k, v (L, B, W, KH, hd) in `dtype`, pos (L, B, W)
    int32 at -1 (empty). ``torch.int8`` selects the quantized cache:
    symmetric int8 with a float32 scale a (slot, head)."""
    n = cfg.n_layers if n_layers is None else n_layers
    shp = ((n,) if n else ()) + (batch, width, cfg.n_kv_heads,
                                 cfg.head_dim_)
    c = {"k": torch.zeros(shp, dtype=dtype, device=device),
         "v": torch.zeros(shp, dtype=dtype, device=device),
         "pos": torch.full(shp[:-2], -1, dtype=torch.int32, device=device)}
    if dtype == torch.int8:
        c["k_scale"] = torch.zeros(shp[:-1], device=device)
        c["v_scale"] = torch.zeros(shp[:-1], device=device)
    return c


def _quantize_kv(x):
    """x: (..., hd) -> (int8 codes, (...,) float32 absmax / 127 scale):
    round half to even, clipped to +-127."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    codes = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale


def _dequantize_kv(codes, scale, dtype):
    return (codes.float() * scale[..., None]).to(dtype)


# --------------------------------------------------------------------------
# MLP (gated and plain)
# --------------------------------------------------------------------------

def init_mlp(cfg, gen: torch.Generator, dtype=torch.float32, d_ff=None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"w_up": fan_in_init(gen, (d, f), dtype),
         "w_down": fan_in_init(gen, (f, d), dtype)}
    if cfg.gated_mlp:
        p["w_gate"] = fan_in_init(gen, (d, f), dtype)
    return p


def mlp_block(cfg, p, x):
    a = act_fn(cfg.act)
    h = x @ p["w_up"]
    h = a(x @ p["w_gate"]) * h if "w_gate" in p else a(h)
    return constrain(h, "tokens_bsf") @ p["w_down"]


# --------------------------------------------------------------------------
# Mixture of Experts — sort-based capacity dispatch
# --------------------------------------------------------------------------

MOE_IMPLS = ("auto", "scatter", "ep")


def _expert_init(gen: torch.Generator, n: int, shape, std, dtype):
    """(n, *shape) N(0, std^2) in `dtype`, drawn one expert at a time, so
    a full-width stack never holds float32 draws of all its experts."""
    out = torch.empty((n, *shape), dtype=dtype, device=gen.device)
    if out.is_meta:                # shapes only (`transformer.param_shapes`)
        return out
    for i in range(n):
        out[i] = normal_init(gen, shape, std, dtype)
    return out


def init_moe(cfg, gen: torch.Generator, dtype=torch.float32):
    """Router (d, E) in float32 whatever `dtype`, as the reference's;
    stacked experts w_up, w_gate (E, d, f) and w_down (E, f, d); with
    ``n_shared_experts`` a shared MLP of width d_ff * n_shared."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": fan_in_init(gen, (d, e), torch.float32),
         "w_up": _expert_init(gen, e, (d, f), 1 / math.sqrt(d), dtype),
         "w_down": _expert_init(gen, e, (f, d), 1 / math.sqrt(f), dtype)}
    if cfg.gated_mlp:
        p["w_gate"] = _expert_init(gen, e, (d, f), 1 / math.sqrt(d), dtype)
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(cfg, gen, dtype,
                               d_ff=cfg.d_ff * cfg.n_shared_experts)
    return p


def moe_capacity(cfg, t: int) -> int:
    """Slots an expert for `t` tokens: the reference's Python expression,
    min(max(int(T k / E * capacity_factor), 4), T)."""
    c = max(int(t * cfg.n_experts_active / cfg.n_experts
                * cfg.moe_capacity_factor), 4)
    return min(c, t)


def moe_route(cfg, logits):
    """(T, E) float32 router logits -> (probs (T, E), gate_vals (T, k)
    renormalised to sum to 1, idx (T, k) largest first)."""
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.topk(probs, cfg.n_experts_active, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, idx


def moe_slots(cfg, idx, c: int):
    """Each assignment's slot: the T * k assignments (token-major, as
    idx.reshape(-1)) stably sorted by expert id; the i-th sorted
    assignment of expert e takes slot (e, i) when i < c, else the
    overflow slot (0, c). Returns (order, slot_e, slot_c, valid), each
    (T * k,) in sorted order; order[j] is the j-th sorted assignment."""
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    experts = torch.arange(cfg.n_experts, device=idx.device)
    starts = torch.searchsorted(se, experts)
    pos = torch.arange(se.numel(), device=idx.device) - starts[se]
    valid = pos < c
    slot_e = torch.where(valid, se, 0)
    slot_c = torch.where(valid, pos, c)
    return order, slot_e, slot_c, valid


def _moe_dispatch_local(cfg, xf, logits, c: int):
    """Sort-based dispatch. xf (T, d); logits (T, E) float32. Returns
    (buf (E, C + 1, d), slot_e, slot_c, order, gate_vals, (me, ce)): me
    the mean router probability of each expert (differentiable), ce the
    share of the T * k assignments it was given (counts, no gradient)."""
    t, k = xf.shape[0], cfg.n_experts_active
    probs, gate_vals, idx = moe_route(cfg, logits)
    me = probs.mean(dim=0)
    flat_e = idx.reshape(-1)
    ce = torch.zeros(cfg.n_experts, device=xf.device).index_add_(
        0, flat_e, torch.ones(t * k, device=xf.device)) / (t * k)
    order, slot_e, slot_c, _ = moe_slots(cfg, idx, c)
    # kept slots are written once each; every dropped assignment goes to
    # the overflow slot (0, c), which no reader keeps
    buf = xf.new_zeros((cfg.n_experts, c + 1, xf.shape[1])).index_put(
        (slot_e, slot_c), xf[order // k])
    return buf, slot_e, slot_c, order, gate_vals, (me, ce)


def _experts(cfg, p, buf):
    """(E, C, d) -> (E, C, d): each expert's gated MLP on its slots."""
    a = act_fn(cfg.act)
    h = torch.bmm(buf, p["w_up"])
    h = a(torch.bmm(buf, p["w_gate"])) * h if "w_gate" in p else a(h)
    return torch.bmm(h, p["w_down"])


def moe_block(cfg, p, x):
    """x (B, S, d) -> (out (B, S, d) in x's dtype, aux float32).

    aux is the Switch load-balance loss E * sum(me * ce) *
    router_aux_loss_coef. Assignments beyond an expert's capacity
    (`moe_capacity`) are dropped: they add nothing, and the token keeps
    its other experts' and the shared expert's contributions.

    On a mesh (a DTensor `x`) the dispatch sorts every token of the
    batch: DTensor has no strategy for `searchsorted` and the others,
    so the tokens and their router logits are gathered to every rank
    (replicated over the batch, as GSPMD places the reference's global
    argsort), the routing, scatter, gather and unsort run on those local
    copies, and the expert products run on the DTensor weights with the
    capacity buffer's experts on ``model`` (``moe_ecd``)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_active
    t = b * s
    xf = x.reshape(t, d)
    logits = xf.float() @ p["router"]
    on_mesh = is_dtensor(xf)
    x_mesh = xf
    if on_mesh:
        xf, logits = xf.full_tensor(), logits.full_tensor()
    c = moe_capacity(cfg, t)
    buf, slot_e, slot_c, order, gate_vals, (me, ce) = _moe_dispatch_local(
        cfg, xf, logits, c)
    aux = e * torch.sum(me * ce) * cfg.router_aux_loss_coef
    buf = constrain(replicated_like(buf[:, :c], x_mesh), "moe_ecd")
    out_buf = _experts(cfg, p, buf)
    if on_mesh:
        out_buf = out_buf.full_tensor()
    out_buf = torch.cat([out_buf, out_buf.new_zeros((e, 1, d))], dim=1)
    gathered = out_buf[slot_e, slot_c]               # sorted order
    unsorted = gathered.new_zeros((t * k, d)).index_put((order,), gathered)
    y = torch.einsum("tkd,tk->td", unsorted.reshape(t, k, d),
                     gate_vals.to(x.dtype))
    y = replicated_like(y, x_mesh)
    if "shared" in p:
        y = y + mlp_block(cfg, p["shared"], x_mesh)
    return y.reshape(b, s, d), replicated_like(aux, x_mesh)


class _GradScale(torch.autograd.Function):
    """The identity, whose backward multiplies the gradient by `scale`."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _model_axis(mesh):
    """(the ``model`` mesh dim, its size), or (None, 1) without one."""
    names = tuple(mesh.mesh_dim_names or ())
    if "model" not in names:
        return None, 1
    i = names.index("model")
    return i, mesh.size(i)


def _batch_dims(mesh) -> list:
    return [i for i, n in enumerate(mesh.mesh_dim_names or ())
            if n in ("pod", "data")]


def _local_in(t, placements):
    """`t`'s local shard at `placements`, differentiable: its gradient is
    declared partial (summed over ranks) on every mesh dim `t` is
    replicated on, since each rank adds its own tokens' share."""
    from torch.distributed.tensor import Partial, Replicate
    g_pl = [Partial() if isinstance(p, Replicate) else p for p in placements]
    return mesh_to_local(t, placements, g_pl)


class _AllToAll(torch.autograd.Function):
    """x (M, ...) -> (M, ...) over a group of M ranks: chunk i of dim 0
    goes to rank i, chunk j of the result came from rank j
    (`lax.all_to_all` with split and concat axis 0). Its transpose is
    the same exchange, so the backward runs it on the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        torch.distributed.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g, ctx.group), None


class _AllReduceSum(torch.autograd.Function):
    """x summed over the ranks of a group; the gradient of each rank's
    x is the sum of the ranks' output gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        torch.distributed.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


def moe_block_ep(cfg, p, x):
    """Expert-parallel MoE: each rank routes its own tokens and the
    capacity buffer's expert blocks go to their ``model`` ranks and back
    with two all_to_alls, as the reference's `shard_map` does (its
    §Perf iteration 2: the global argsort of `moe_block` replicates the
    token buffers under GSPMD).

    The tokens are sharded over the batch axes when B divides over them
    (else replicated) and replicated over ``model``, so each ``model``
    rank of a batch shard routes the same tokens, as in the reference;
    the capacity is `moe_capacity` of the local token count; each
    ``model`` rank holds E / M experts, all-gathered over the batch
    axes (the FSDP gather). The aux loss averages each shard's me and ce
    over the batch axes. Runs on local shards (``to_local``) with a
    differentiable all_to_all over the ``model`` group: every
    local input's gradient is partial over the mesh dims it is
    replicated on, and each output's incoming gradient is divided by its
    number of replicas, so the sums are the true gradients.

    Falls back to `moe_block` where `x` is no DTensor, the mesh has no
    ``model`` dim larger than 1, or E does not divide over it."""
    dim, m = _model_axis(x.device_mesh) if is_dtensor(x) else (None, 1)
    e, k = cfg.n_experts, cfg.n_experts_active
    if m == 1 or e % m:
        return moe_block(cfg, p, x)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = x.device_mesh
    e_loc = e // m
    b, s, d = x.shape
    bdims = _batch_dims(mesh)
    n_b = math.prod(mesh.size(i) for i in bdims)
    split = bool(bdims) and b % n_b == 0
    x_pl = [Shard(0) if split and i in bdims else Replicate()
            for i in range(mesh.ndim)]
    w_pl = [Shard(0) if i == dim else Replicate() for i in range(mesh.ndim)]
    xl = _local_in(x, x_pl)
    router = _local_in(p["router"], [Replicate()] * mesh.ndim)
    w = {n: _local_in(p[n], w_pl)
         for n in ("w_up", "w_gate", "w_down") if n in p}
    group = mesh.get_group(dim)

    bl = xl.shape[0]
    t = bl * s
    xf = xl.reshape(t, d)
    c = moe_capacity(cfg, t)
    buf, slot_e, slot_c, order, gate_vals, (me, ce) = _moe_dispatch_local(
        cfg, xf, xf.float() @ router, c)
    recv = _AllToAll.apply(buf[:, :c].reshape(m, e_loc, c, d), group)
    toks = recv.transpose(0, 1).reshape(e_loc, m * c, d)
    out = _experts(cfg, w, toks).reshape(e_loc, m, c, d).transpose(0, 1)
    out_buf = _AllToAll.apply(out, group).reshape(e, c, d)
    out_buf = torch.cat([out_buf, out_buf.new_zeros((e, 1, d))], dim=1)
    gathered = out_buf[slot_e, slot_c]
    unsorted = gathered.new_zeros((t * k, d)).index_put((order,), gathered)
    y = torch.einsum("tkd,tk->td", unsorted.reshape(t, k, d),
                     gate_vals.to(xl.dtype))
    if bdims:                                  # pmean over the batch axes
        for i in bdims:
            me = _AllReduceSum.apply(me, mesh.get_group(i))
            ce = _AllReduceSum.apply(ce, mesh.get_group(i))
        me, ce = me / n_b, ce / n_b
    aux = e * torch.sum(me * ce) * cfg.router_aux_loss_coef
    reps_y = mesh.size() // (n_b if split else 1)
    y = local_to_mesh(_GradScale.apply(y.reshape(bl, s, d), 1 / reps_y),
                      mesh, x_pl, x.shape)
    aux = DTensor.from_local(_GradScale.apply(aux, 1 / mesh.size()), mesh,
                             [Replicate()] * mesh.ndim, run_check=False)
    if "shared" in p:
        y = y + mlp_block(cfg, p["shared"], x.reshape(-1, d)).reshape(
            x.shape)
    return y, aux


def _ep_pays(cfg, x) -> bool:
    """The reference's "auto" rule: the expert-parallel path on a mesh
    with a ``model`` dim larger than 1 that E divides, and only when each
    batch shard sends at least one token an expert (at decode-sized
    token counts the capacity padding and the all_to_alls dominate)."""
    if not is_dtensor(x):
        return False
    mesh = x.device_mesh
    _, m = _model_axis(mesh)
    if m == 1 or cfg.n_experts % m:
        return False
    n_b = math.prod(mesh.size(i) for i in _batch_dims(mesh))
    t_loc = x.shape[0] * x.shape[1] / max(n_b, 1)
    return t_loc * cfg.n_experts_active / cfg.n_experts >= 1.0


def moe_apply(cfg, p, x):
    """The MoE implementation `cfg.moe_impl` names, as the reference's:
    "ep" runs `moe_block_ep` (which falls back to `moe_block` off a
    model-parallel mesh), "auto" runs it where `_ep_pays`, else
    `moe_block`; "scatter" always runs `moe_block`."""
    if cfg.moe_impl not in MOE_IMPLS:
        raise ValueError(f"unknown moe_impl {cfg.moe_impl!r}; valid: "
                         f"{MOE_IMPLS}")
    if cfg.moe_impl == "ep" or (cfg.moe_impl == "auto"
                                and _ep_pays(cfg, x)):
        return moe_block_ep(cfg, p, x)
    return moe_block(cfg, p, x)


def moe_block_dense_ref(cfg, p, x):
    """Every token through every expert, then the top-k by gate: the
    reference's oracle of `moe_block` when nothing drops."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    _, gate_vals, idx = moe_route(cfg, xf.float() @ p["router"])
    a = act_fn(cfg.act)
    h = torch.einsum("td,edf->tef", xf, p["w_up"])
    if "w_gate" in p:
        h = a(torch.einsum("td,edf->tef", xf, p["w_gate"])) * h
    else:
        h = a(h)
    all_out = torch.einsum("tef,efd->ted", h, p["w_down"])
    sel = torch.take_along_dim(all_out, idx[..., None], dim=1)
    y = torch.einsum("tkd,tk->td", sel, gate_vals.to(x.dtype))
    if "shared" in p:
        y = y + mlp_block(cfg, p["shared"], xf)
    return y.reshape(b, s, d)


# --------------------------------------------------------------------------
# RWKV6 (Finch) time-mix
# --------------------------------------------------------------------------

def init_rwkv_tmix(cfg, gen: torch.Generator, dtype=torch.float32):
    d = cfg.d_model
    return {
        "mu": normal_init(gen, (5, d), 0.1, dtype),    # shift-mix r,k,v,g,w
        "wr": fan_in_init(gen, (d, d), dtype),
        "wk": fan_in_init(gen, (d, d), dtype),
        "wv": fan_in_init(gen, (d, d), dtype),
        "wg": fan_in_init(gen, (d, d), dtype),
        "w0": normal_init(gen, (d,), 0.5) - 2.0,        # base decay, f32
        "w_lora_a": fan_in_init(gen, (d, 64), dtype),
        "w_lora_b": normal_init(gen, (64, d), 0.01),    # f32
        "u": normal_init(gen, (d,), 0.1),               # bonus, f32
        "wo": fan_in_init(gen, (d, d), dtype),
    }


def _shift(x, x_last):
    """The previous token of each position: x_last (B, d) or zeros first."""
    first = x_last[:, None] if x_last is not None else torch.zeros_like(x[:, :1])
    return torch.cat([first, x[:, :-1]], dim=1)


def _rwkv_project(cfg, p, x, x_prev):
    """Token-shift mixing + projections. x, x_prev: (B, S, d). Returns
    r, k, v, g in x's dtype and the float32 log-decay, clamped to
    [RWKV_DECAY_FLOOR, -1e-4]. Each of the five mixes is formed on its own
    (the reference stacks them; the same elementwise arithmetic)."""
    mu = p["mu"].float()
    xs, xp = x.float(), x_prev.float()
    diff = xp - xs

    def mixed(i):
        return (xs + diff * mu[i]).to(x.dtype)

    r = mixed(0) @ p["wr"]
    k = mixed(1) @ p["wk"]
    v = mixed(2) @ p["wv"]
    g = F.silu(mixed(3) @ p["wg"])
    lw = p["w0"] + torch.tanh(mixed(4) @ p["w_lora_a"]).float() @ p["w_lora_b"]
    logw = torch.clamp(-torch.exp(lw), RWKV_DECAY_FLOOR, -1e-4)
    return r, k, v, g, logw


def _shard_placements(ref, model_dim, n: int) -> list:
    """Placements of a tensor a local op reads or writes on a mesh:
    `ref`'s batch split (``Shard(0)`` on each mesh dim that shards
    `ref`'s dim 0, the tokens' placement) and, on the ``model`` dim,
    ``Shard(model_dim)`` where ``model`` divides `n`, the size of the
    dim the op splits there (the heads, or di); replicated elsewhere
    (`model_dim` None: nothing on ``model``)."""
    from torch.distributed.tensor import Replicate, Shard
    pl = [Shard(0) if q == Shard(0) else Replicate() for q in ref.placements]
    dim, m = _model_axis(ref.device_mesh)
    if dim is not None:
        pl[dim] = (Shard(model_dim) if model_dim is not None and n % m == 0
                   else Replicate())
    return pl


def _work_grads(pl, work) -> list:
    """Gradient placements of a local op's input at placements `pl`,
    where the op's work is split as `work` (its output's placements):
    partial (each rank adds its share) on each mesh dim the work is
    split over and the input is whole, else the input's own."""
    from torch.distributed.tensor import Partial, Replicate
    return [Partial() if p == Replicate() and w != Replicate() else p
            for p, w in zip(pl, work)]


def _rwkv6_heads(r, k, v, logw, u, state, hd: int):
    """The chunked recurrence of (B, S, d) projections on the rwkv6
    kernel (`ops.rwkv6`, the plain chunked version on the CPU), read in
    their (B, S, H, D) layout in place: u (d,), state (B, H, D, D) or
    None. Returns (o (B, S, d) float32, the new state float32)."""
    b, s, d = r.shape
    h = d // hd

    def heads(t):
        return t.float().contiguous().view(b, s, h, hd)

    if state is not None:
        state = state.float().contiguous()
    o, state = ops.rwkv6(heads(r), heads(k), heads(v), heads(logw),
                         u.float().view(h, hd), state)
    return o.view(b, s, d), state


def _rwkv6_step_heads(r, k, v, logw, u, state, hd: int):
    """One token of the recurrence in plain torch, as the reference's is
    jnp: (B, 1, d) projections, u (d,), state (B, H, D, D) float32.
    Returns (o (B, 1, d) float32, the new state)."""
    b, _, d = r.shape
    h = d // hd
    rh, kh, vh = (t.float().reshape(b, h, hd) for t in (r, k, v))
    w = torch.exp(logw.reshape(b, h, hd))
    u = u.float().view(h, hd)
    kv = kh[..., :, None] * vh[..., None, :]                 # (B, H, D, D)
    o = torch.einsum("bhd,bhde->bhe", rh, state + u[None, :, :, None] * kv)
    return o.reshape(b, 1, d), state * w[..., None] + kv


def rwkv6_on_shards(ref, fn, r, k, v, logw, u, state, hd: int):
    """The recurrence `fn` (`_rwkv6_heads`, the rwkv6 kernel's path, or
    `_rwkv6_step_heads`, the decode step's) on DTensors, run on each
    rank's shards: the recurrence is independent per (sequence, head),
    so each rank runs it (launches the kernel) on its own batch rows and
    heads, with no collective. r, k, v, logw (B, S, d) take the tokens'
    (`ref`'s) batch placement and, where ``model`` divides the H = d /
    `hd` heads, d on ``model`` (the layout of wr/wk/wv's (fs, "model")
    and w_lora_b's (None, "model")); u (d,) is sliced to the local heads
    (its gradient partial where the work is split); `state` (B, H, D, D)
    or None is read as the cache's (bax, "model") shard. The gradient
    goes through `ops._RWKV6` on the local tensors, as on one card.
    Returns (o (B, S, d) float32 with r's placements, the new state
    (B, H, D, D) float32 with the cache's), as DTensors."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = r.device_mesh
    b, s, d = r.shape
    h = d // hd
    pl = _shard_placements(ref, 2, h)                  # (B, S, d)
    st_pl = _shard_placements(ref, 1, h)               # (B, H, D, D)
    u_pl = [Shard(0) if q == Shard(2) else Replicate() for q in pl]
    rl, kl, vl, wl = (mesh_to_local(t, pl) for t in (r, k, v, logw))
    ul = mesh_to_local(u, u_pl, _work_grads(u_pl, pl))
    if state is not None:
        state = mesh_to_local(state, st_pl)
    o, state = fn(rl, kl, vl, wl, ul, state, hd)
    return (local_to_mesh(o, mesh, pl, (b, s, d)),
            local_to_mesh(state, mesh, st_pl, (b, h, hd, hd)))


def rwkv_tmix_chunked(cfg, p, x, state=None, x_last=None):
    """RWKV6 time-mix over a full sequence, on the rwkv6 kernel.

    x: (B, S, d); state: (B, H, D, D) float32 carry (k-dim, v-dim) or None;
    x_last: (B, d) token before x[:, 0] or None. Returns (out (B, S, d),
    new_state (B, H, D, D) float32, last_x (B, d)). On a mesh (a DTensor
    `x`) the kernel runs on each rank's shards (`rwkv6_on_shards`)."""
    r, k, v, g, logw = _rwkv_project(cfg, p, x, _shift(x, x_last))
    args = (r, k, v, logw, p["u"], state, cfg.rwkv_head_dim)
    if is_dtensor(x):
        o, state = rwkv6_on_shards(x, _rwkv6_heads, *args)
    else:
        o, state = _rwkv6_heads(*args)
    o = (o.to(x.dtype) * g) @ p["wo"]
    return o, state, x[:, -1]


def rwkv_tmix_step(cfg, p, x, state, x_last):
    """Single-token decode step. x: (B, 1, d); state: (B, H, D, D). On a
    mesh it runs on each rank's shards (`rwkv6_on_shards`), as the
    chunked form does."""
    r, k, v, g, logw = _rwkv_project(cfg, p, x, x_last[:, None])
    args = (r, k, v, logw, p["u"], state, cfg.rwkv_head_dim)
    if is_dtensor(x):
        o, state = rwkv6_on_shards(x, _rwkv6_step_heads, *args)
    else:
        o, state = _rwkv6_step_heads(*args)
    o = o.to(x.dtype) * g
    return o @ p["wo"], state, x[:, -1]


# --------------------------------------------------------------------------
# RWKV6 channel-mix
# --------------------------------------------------------------------------

def init_rwkv_cmix(cfg, gen: torch.Generator, dtype=torch.float32):
    d = cfg.d_model
    return {
        "mu": normal_init(gen, (2, d), 0.1, dtype),
        "w_up": fan_in_init(gen, (d, cfg.d_ff), dtype),
        "w_down": fan_in_init(gen, (cfg.d_ff, d), dtype),
    }


def rwkv_cmix(cfg, p, x, x_last=None):
    """Channel-mix (square-ReLU FFN with token shift). Returns (out
    (B, S, d), last_x (B, d))."""
    xs, xp = x.float(), _shift(x, x_last).float()
    xk = xs + (xp - xs) * p["mu"].float()[0]
    h = torch.square(torch.relu(xk.to(x.dtype) @ p["w_up"]))
    return h @ p["w_down"], x[:, -1]


# --------------------------------------------------------------------------
# Selective SSM (Mamba-style, Hymba's parallel branch)
# --------------------------------------------------------------------------

SSM_CHUNK = 128
# Float32 elements of one (B, chunks, C, di, st) decay tensor of a group
# of chunks scanned together (`_ssm_groups`): 2^27, 537 MB. At hymba's
# width a prefill of 16 x 1024 takes one 128-chunk a group (419 MB), a
# dt step's 8 x 512 two, a training sequence of 4096 20 (26 MB a chunk),
# so its 32 chunks run in 2 groups.
SSM_GROUP_ELEMS = 1 << 27


def init_ssm(cfg, gen: torch.Generator, dtype=torch.float32):
    """w_in (d, 2 di), the width-4 depthwise conv (4, di), w_dt (di, di),
    w_B and w_C (di, st), w_out (di, d) in `dtype`; b_dt, A_log (di, st)
    and D in float32 whatever `dtype`, as the reference's."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    st = cfg.ssm_state
    dev = gen.device
    return {
        "w_in": fan_in_init(gen, (d, 2 * di), dtype),
        "conv": normal_init(gen, (4, di), 0.5, dtype),
        "w_dt": fan_in_init(gen, (di, di), dtype),
        "b_dt": torch.full((di,), -3.0, device=dev),    # softplus(-3) ~ 0.05
        "w_B": fan_in_init(gen, (di, st), dtype),
        "w_C": fan_in_init(gen, (di, st), dtype),
        "A_log": torch.log(torch.arange(1, st + 1, dtype=torch.float32,
                                        device=dev)).repeat(di, 1),
        "D": torch.ones((di,), device=dev),
        "w_out": fan_in_init(gen, (di, d), dtype),
    }


def _ssm_conv(p, x, conv_state=None):
    """Causal depthwise conv of width 4 in float32. x: (B, S, di);
    conv_state: the 3 inputs before x[:, 0] (B, 3, di), or None (zeros).
    Returns (out, the last 3 inputs as the new conv state), both in x's
    dtype. The four terms are summed in the reference's order, a Python
    `sum` from 0."""
    w = p["conv"].float()
    pad = conv_state
    if pad is None:            # on a mesh: a shard of x's placements
        pad = sharded_like(torch.zeros((x.shape[0], 3, x.shape[2]),
                                       dtype=x.dtype, device=x.device), x)
    xp = torch.cat([pad.float(), x.float()], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i] for i in range(4))
    return y.to(x.dtype), xp[:, -3:].to(x.dtype)


def _softplus(v):
    """The reference's softplus, logaddexp(v, 0)."""
    return torch.logaddexp(v, v.new_zeros(()))


def _assoc_scan(a, b):
    """Inclusive scan of the pairs (a, b) along dim 1 under the combine
    (a_l, b_l) . (a_r, b_r) = (a_l a_r, b_l a_r + b_r):
    `jax.lax.associative_scan`'s recursion (its `_scan`) in the same
    association order. Adjacent pairs are combined and scanned, the odd
    results combined with the even inputs, and the two written
    interleaved into the outputs through strided slices: 2 log2(n)
    levels of elementwise passes. Not differentiable: `_SSMScan` has its
    own backward."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ar, br = a[:, 1::2], b[:, 1::2]
    oa, ob = _assoc_scan(a[:, 0:n - 1:2] * ar, b[:, 0:n - 1:2] * ar + br)
    out_a, out_b = torch.empty_like(a), torch.empty_like(b)
    out_a[:, 1::2], out_b[:, 1::2] = oa, ob
    out_a[:, :1], out_b[:, :1] = a[:, :1], b[:, :1]
    m = (n - 1) // 2
    eb = out_b[:, 2::2]
    torch.mul(oa[:, :m], a[:, 2::2], out=out_a[:, 2::2])
    torch.mul(ob[:, :m], a[:, 2::2], out=eb)
    eb.add_(b[:, 2::2])
    return out_a, out_b


def _ssm_groups(b: int, s: int, di: int, st: int, chunk: int):
    """[(s0, s1)]: the sequence cut into groups of whole chunks, each
    group's (B, chunks, C, di, st) float32 decay tensor at most
    SSM_GROUP_ELEMS elements (at least one chunk)."""
    g = max(1, SSM_GROUP_ELEMS // (b * chunk * di * st)) * chunk
    return [(s0, min(s0 + g, s)) for s0 in range(0, s, g)]


def _ssm_states(dt, x1, bm, a_mat, h0, chunk: int):
    """The reference's chunk body over a group of whole chunks at once,
    up to the states. dt, x1: (B, L, di) float32; bm: (B, L, st); a_mat
    (di, st); h0 (B, di, st) the state before the group. Each chunk's
    decays and inputs, exp(dt A) and (dt x1) B, are scanned within the
    chunk (`_assoc_scan`); that scan reads no state, so the group's
    chunks scan together, and the state then passes from chunk to chunk,
    h_j+1 = A_j[-1] h_j + B_j[-1] (the reference's h[:, -1]), and h_t =
    A_t h_j + B_t. Returns (the decays and the states h_t, both (B, g, C,
    di, st), each chunk's starting state (B, g, di, st), the state after
    the group)."""
    b, length, di = dt.shape
    st = a_mat.shape[1]
    g = length // chunk
    dtc = dt.reshape(b * g, chunk, di)
    a = torch.exp(dtc[..., None] * a_mat)                   # (B g, C, di, st)
    u = (dtc * x1.reshape(b * g, chunk, di))[..., None] \
        * bm.reshape(b * g, chunk, st)[:, :, None, :]
    a_, b_ = _assoc_scan(a, u)
    del u
    a_ = a_.view(b, g, chunk, di, st)
    b_ = b_.view(b, g, chunk, di, st)
    starts, h = [], h0
    for j in range(g):
        starts.append(h)
        h = a_[:, j, -1] * h + b_[:, j, -1]
    starts = torch.stack(starts, dim=1)
    hs = torch.mul(a_, starts[:, :, None]).add_(b_)
    return a.view(b, g, chunk, di, st), hs, starts, h


class _SSMScan(torch.autograd.Function):
    """The selective scan over a whole sequence of whole chunks, all
    float32: h_t = exp(dt_t A) h_t-1 + dt_t x1_t B_t, y_t = h_t . C_t.
    apply(dt, x1 (B, S, di), bm, cm (B, S, st), a_mat (di, st), h0 (B, di,
    st), chunk) -> (y (B, S, di), the last state (B, di, st)), S a
    multiple of `chunk`. The forward saves only its inputs and
    the state at each group's start (`_ssm_groups`); the backward walks
    the groups in reverse, recomputes each group's decays and states and
    takes the recurrence's adjoint, g_t = C_t dy_t + a_t+1 g_t+1, by the
    same associative scan run backwards in time within each chunk, the
    chunks chained by their carries (dL/dh before a chunk = a_first
    g_first). Plain autograd would keep a dozen (B, C, di, st) float32
    tensors a chunk alive (at hymba's width 26 MB each a sequence, about
    10 GB a sequence a layer at S = 4096) and accumulate the strided
    slices' gradients into zeroed buffers level by level. The profiler
    sees the forward as the range ``ssm.scan`` and the backward as
    ``ssm.recompute``."""

    @staticmethod
    def forward(ctx, dt, x1, bm, cm, a_mat, h0, chunk):
        b, s, di = dt.shape
        groups = _ssm_groups(b, s, di, a_mat.shape[1], chunk)
        y = torch.empty_like(dt)
        starts, h = [], h0
        with torch.profiler.record_function("ssm.scan"):
            for s0, s1 in groups:
                starts.append(h)
                _, hs, _, h = _ssm_states(dt[:, s0:s1], x1[:, s0:s1],
                                          bm[:, s0:s1], a_mat, h, chunk)
                y[:, s0:s1] = torch.einsum(
                    "bgcdn,bgcn->bgcd", hs,
                    cm[:, s0:s1].reshape(hs.shape[:3] + cm.shape[-1:])
                ).reshape(b, s1 - s0, di)
                del hs
        ctx.save_for_backward(dt, x1, bm, cm, a_mat, *starts)
        ctx.groups, ctx.chunk = groups, chunk
        return y, h

    @staticmethod
    def backward(ctx, g_y, g_h):
        dt, x1, bm, cm, a_mat, *starts = ctx.saved_tensors
        chunk = ctx.chunk
        grads = [torch.empty_like(t) for t in (dt, x1, bm, cm)]
        g_a = torch.zeros_like(a_mat)
        di, st = a_mat.shape
        for (s0, s1), h0 in zip(reversed(ctx.groups), reversed(starts)):
            with torch.profiler.record_function("ssm.recompute"):
                a, hs, h_starts, _ = _ssm_states(
                    dt[:, s0:s1], x1[:, s0:s1], bm[:, s0:s1], a_mat, h0,
                    chunk)
                b, g = hs.shape[:2]

                def chunks(t):
                    return t[:, s0:s1].reshape(b, g, chunk, t.shape[-1])

                dtc, x1c, bmc, cmc, gyc = (chunks(t) for t in
                                           (dt, x1, bm, cm, g_y))
                d_cm = torch.einsum("bgcdn,bgcd->bgcn", hs, gyc)
                # the adjoint within each chunk, backwards in time:
                # g_t = dy_t C_t + alpha_t g_t+1, alpha_t = a_t+1 (1 last)
                alpha = torch.ones_like(a)
                alpha[:, :, :-1] = a[:, :, 1:]
                flat = (b * g, chunk, di, st)
                ga, gb = _assoc_scan(
                    alpha.view(flat).flip(1),
                    (gyc[..., None] * cmc[..., None, :]).view(flat).flip(1))
                del alpha
                ga, gb = ga.view(b, g, chunk, di, st), gb.view(b, g, chunk,
                                                               di, st)
                carries, c = [], g_h
                for j in reversed(range(g)):
                    carries.append(c)
                    c = a[:, j, 0] * (ga[:, j, -1] * c + gb[:, j, -1])
                g_h = c
                adj = ga.mul_(torch.stack(carries[::-1], dim=1)[:, :, None]
                              ).add_(gb).flip(2)
                del ga, gb
                dtx1 = dtc * x1c
                d_bm = torch.einsum("bgcdn,bgcd->bgcn", adj, dtx1)
                d_dtx1 = torch.einsum("bgcdn,bgcn->bgcd", adj, bmc)
                # dL/da_t = g_t h_t-1, and a = exp(dt A): dz = dL/da a
                adj[:, :, 1:].mul_(hs[:, :, :-1])
                adj[:, :, 0].mul_(h_starts)
                del hs
                dz = adj.mul_(a)
                del a
                d_dt = torch.einsum("bgcdn,dn->bgcd", dz, a_mat) \
                    + d_dtx1 * x1c
                g_a += torch.einsum("bgcdn,bgcd->dn", dz, dtc)
                del dz
                for out, gr in zip(grads, (d_dt, d_dtx1 * dtc, d_bm, d_cm)):
                    out[:, s0:s1] = gr.reshape(b, s1 - s0, -1)
        return (*grads, g_a, g_h, None)


def _ssm_scan_on_shards(ref, dt, x1, bm, cm, a_mat, h0, chunk: int):
    """`_SSMScan` on DTensors, run on each rank's shards: the scan is
    independent per channel of di, so each rank scans its batch rows
    (`ref`'s batch placement) and, where ``model`` divides di, its di
    shard: dt and x1 (B, S, di) on di, bm and cm (B, S, st) whole
    (reduced to replicated over ``model`` here, since w_B and w_C are
    ("model", None) and leave them partial), a_mat (di, st) its rows,
    h0 (B, di, st) the cache's ``ssm`` shard (bax, "model"), or zeros
    made as that shard where None. The backward (``ssm.recompute``) runs
    on the same shards. Returns (y (B, S, di) with dt's placements, the
    last state (B, di, st) with the cache's), as DTensors."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = dt.device_mesh
    b, s, di = dt.shape
    st = a_mat.shape[1]
    pl_c = _shard_placements(ref, 2, di)               # (B, S, di)
    pl_n = _shard_placements(ref, None, 0)             # (B, S, st)
    pl_h = _shard_placements(ref, 1, di)               # (B, di, st)
    pl_a = [Shard(0) if q == Shard(2) else Replicate() for q in pl_c]
    dtl, x1l = (mesh_to_local(t, pl_c) for t in (dt, x1))
    bml, cml = (mesh_to_local(t, pl_n, _work_grads(pl_n, pl_c))
                for t in (bm, cm))
    al = mesh_to_local(a_mat, pl_a, _work_grads(pl_a, pl_c))
    if h0 is None:
        h0 = torch.zeros((dtl.shape[0], dtl.shape[2], st), device=dtl.device)
    else:
        h0 = mesh_to_local(h0, pl_h)
    y, h = _SSMScan.apply(dtl, x1l, bml, cml, al, h0, chunk)
    return (local_to_mesh(y, mesh, pl_c, (b, s, di)),
            local_to_mesh(h, mesh, pl_h, (b, di, st)))


def ssm_block(cfg, p, x, state=None, conv_state=None):
    """Selective SSM. x: (B, S, d) -> (out (B, S, d), (h_state (B, di, st)
    float32, conv_state (B, 3, di) in x's dtype)); `state` and
    `conv_state` None start from zeros.

    h_t = exp(dt_t A) h_t-1 + dt_t (x_t B_t); y_t = h_t . C_t + D x_t,
    gated by silu(z), over chunks of min(SSM_CHUNK, S). An S that is no
    multiple of the chunk runs as the reference's does: its whole chunks,
    then the rest as one chunk, the states threaded between them."""
    b, s, d = x.shape
    di, st = cfg.ssm_expand * d, cfg.ssm_state
    c0 = min(SSM_CHUNK, s)
    if s % c0:
        s_main = (s // c0) * c0
        o1, (h1, c1) = ssm_block(cfg, p, x[:, :s_main], state, conv_state)
        o2, (h2, c2) = ssm_block(cfg, p, x[:, s_main:], h1, c1)
        return torch.cat([o1, o2], dim=1), (h2, c2)
    x1, z = (x @ p["w_in"]).chunk(2, dim=-1)
    if is_dtensor(x):          # each half on di over model, conv's layout
        pl = _shard_placements(x, 2, di)
        x1, z = (t.redistribute(t.device_mesh, pl) for t in (x1, z))
    x1, conv_state = _ssm_conv(p, x1, conv_state)
    x1 = F.silu(x1)
    dt = _softplus(x1 @ p["w_dt"] + p["b_dt"]).float()       # (B, S, di)
    bm = (x1 @ p["w_B"]).float()                             # (B, S, st)
    cm = (x1 @ p["w_C"]).float()
    a_mat = -torch.exp(p["A_log"])                           # (di, st)
    x1f = x1.float()
    if is_dtensor(x):
        y, h = _ssm_scan_on_shards(x, dt, x1f, bm, cm, a_mat, state, c0)
    else:
        if state is None:
            state = torch.zeros((b, di, st), device=x.device)
        y, h = _SSMScan.apply(dt, x1f, bm, cm, a_mat, state, c0)
    y = y + p["D"] * x1f
    y = y.to(x.dtype) * F.silu(z)
    return y @ p["w_out"], (h, conv_state)


def ssm_step(cfg, p, x, state, conv_state):
    """Single-token decode step. x: (B, 1, d)."""
    return ssm_block(cfg, p, x, state=state, conv_state=conv_state)
