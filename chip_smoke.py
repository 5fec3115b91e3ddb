#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with one CUDA card,
nvcc and PyTorch built for CUDA. Imports nothing of JAX and nothing of
the JAX package `repro`. Phases, each of which must pass:

1. Prints the card (``nvidia-smi --query-gpu=name,power.limit``) and the
   torch/CUDA versions, then builds every kernel of
   src/repro_torch/kernels/csrc/ with nvcc (in parallel) into build/.
2. Kernel phase: each kernel against its plain PyTorch version on the
   card, at the main path's shapes —
   * wagg at m = 5, P = 11,506,624 (ResNet-18-CIFAR's flat row): plain,
     masked, padded to m = 8 with n = 5 (bitwise equal to the unpadded
     call), and cut to P - 3 columns (bitwise equal to the aligned call's
     first P - 3); atol 1e-5 against `ref.wagg_ref`;
   * dt_loss at (512, 128), (500, 128) and (513, 128) (ragged row and key
     edges), each at the tau pairs (0.1, 1.0) and (0.07, 1.0): loss,
     lse_a, lse_b, pos at atol 2e-5 against `ref.dt_loss_fwd_ref`, two
     calls bitwise equal; gradients of the mean loss through the
     autograd.Function at atol 1e-5 against autograd of the plain
     `core.dt_loss.dt_loss_matrix`. Then its cohort form, one launch for
     C clients, at (C, M, D) = (5, 512, 128), (3, 500, 128) and (3, 513,
     128) (ragged rows and keys at the client boundaries), both tau
     pairs, against `ref.dt_loss_fwd_cohort_ref` at the same tolerances,
     two calls bitwise equal, and the gradients through
     ``torch.func.vmap(torch.func.grad)`` (one launch) against a loop of
     the unbatched autograd path. Timed at C = 1, 3 and 5 (M = 512): the
     device time a launch and a client beside the bound, C times the
     C = 1 bound; the row's numbers are at (3, 512, 128), the main
     path's chunk. The kernel is the Hopper design (3xTF32 mma.sync, keys
     split over a cluster of 8 CTAs, TMA tensor copies, the client on the
     grid's y); its line gives its registers and local (spill) bytes a
     thread, shared bytes a CTA and CTAs an SM
     (`kernels.dt_loss.kernel_attributes`).
   Times each with CUDA events around calls of its Python wrapper
   (``ms``: the wrapper's host work included), the plain version, and for
   wagg the library yardstick ``w @ x``, which the port never calls. Each
   kernel's own device time (``device_ms``) is the self device time of
   its launches under torch.profiler over their count (`_device_ms`); a
   trace without it fails the run.
   Then ``[analysis]``, the port's analysis layer (repro_torch.analysis):
   inside `guards.no_implicit_transfers` an ``.item()`` and a ``.cpu()``
   of a CUDA tensor each raise, and the sync debug mode is back to its
   previous value after each block (whether a ``torch.cuda.synchronize()``
   raises there is printed, not held); the kernel builds `track_compiles`
   counted around the first `build.build_all()`, and 0 around a second;
   `contracts.check_all()` over fake CPU tensors finds nothing; the
   port's lint over src/repro_torch finds nothing beyond its baseline.
3. Cross-check: one small round on the card and the same round with
   ``device="cpu"``, compared with allclose (tolerances below).
4. Main path: 3 rounds of the paper's Table-1 setting (95 vehicles,
   Dirichlet 0.1, 5 per round, batch 512, ResNet-18-CIFAR at full width)
   through `Scenario` / `run_round` with the batched cohort step
   (``parallel=True``, the default: chunks of CLIENTS_PER_CHUNK = 3
   clients, so dt_loss launches twice a round, for 3 + 2 clients), with
   every kernel launch counter set to 0 just before and read just after;
   then 3 rounds from round 0 with ``parallel=False`` (dt_loss 5 a
   round), timed beside them, with the peak memory of each.
   Every phase's expected launches come from the round's plan by one
   stated rule (`_round_launches`; `_engine_launches` for the campaign
   engine, which trains the whole cohort unpadded).
5. Comms path: 3 more Table-1 rounds from round 0 with
   ``codec="delta_int8"`` through `Scenario` / `run`, each published into
   a ``ModelStore(codec="delta_int8")`` bootstrapped with round 0; the
   counters, zeroed just before, must read q8_encode 6 and q8_decode 6
   (3 cohort roundtrips, 3 publishes), wagg 3 and dt_loss 6.
6. The batched step, checkpoints, the topologies, FedCo and the probe,
   at the Table-1 setting on the [main] path's data, each with the
   counters zeroed just before:
   * ``[batched]``: one Table-1 round from one state with
     ``parallel=True`` and with ``parallel=False``, and one handover
     round whose plan pads a download group to its bucket: loss and
     trees within the cross-check tolerances, records equal; the peak
     memory of each, the batched Table-1 round's at most PEAK_GIB;
   * ``[resume]``: 4 Table-1 rounds, the state saved with `save_state`
     at round 2, restored with `restore_state` from disk (bitwise the
     saved state) and run again to round 4: the schedule (ids, batch
     indices, velocities, lr) and the host_rng and gen_state after it
     bitwise, the trees within CROSS_MAX_ABS (card runs are not bitwise
     repeatable); the same for the handover with ``delta_int8``
     (positions, RSU models, error feedback; one code step more);
   * ``[engine]``: the campaign engine (`run_campaign`), the general
     cache released before it and the engine's graph after it: small
     rounds of every topology with every codec, a replayed round against
     the eager one from one state; 4 Table-1 rounds in ``mode="graph"`` (one CUDA graph a round, one
     capture across two chunks of ``checkpoint_every=2``, published into
     a ``ModelStore``), warm replays under ``transfer_guard=True`` and one
     under torch.profiler (the kernels inside a replay), then each chunk
     again in ``mode="eager"`` and through `run`: the schedule bitwise,
     the trees within CROSS_MAX_ABS chunk by chunk, launches wagg 1 and
     dt_loss 2 a round from the replays; 5 handover rounds (delta_int8,
     the sync at round 4) graph against eager; 2 MultiRSU rounds graph
     against `run`. Every ``compile_counts`` goes through
     `guards.assert_compile_bounds` and equals ``ENGINE_COMPILE_BOUNDS``;
     the Table-1 graph chunks, the guarded replays, the handover's and
     MultiRSU's graph campaigns each run inside `guards.track_compiles`,
     whose captures must equal the growth of ``compile_counts`` over the
     block, 0 captures and 0 kernel builds over the guarded replays.
     Prints seconds a round, host ms a round, the device's idle share,
     the peak memory, the graph pool and the capture's seconds for each
     mode;
   * ``[topo]``: small rounds of MultiRSU(n_rsus=2), the handover (two
     rounds with a handover and the region sync) and FedCo, each from
     one state on the card and with ``device="cpu"``; loss, global tree,
     every RSU model, FedCo's key tree and queue at the cross-check
     tolerances, records equal. MultiRSU and the handover once more with
     ``codec="delta_int8"`` (the q8 kernels at the groups' shapes, the
     error-feedback slots chosen by cohort index): max abs differences
     of the trees and of ``comms["ef"]`` get one code step of the
     largest block scale either side encoded with on top of
     CROSS_MAX_ABS (a code may flip by one step), and the card's q8
     launches equal its encodes, one per group;
   * ``[multi]``: 2 rounds of MultiRSU(n_rsus=2): rsu_sizes [3, 2],
     dt_loss 4 (one chunk a group), wagg 2 x (2 groups + 1 region) = 6;
   * ``[mesh]``: sharded cohorts over NCCL at world size 1 (one card,
     one rank; `launch/mesh.py` makes the one-rank group, gloo for CPU
     tensors beside NCCL, and a CPU mesh on it sums bitwise): at full width
     (P = 11,506,624, 5 rows) `sharded_cohort_sum` ("gather", "split")
     and `sharded_hierarchical` ("exact") bitwise their host forms,
     "psum" within WAGG_TOL, `sharded_aggregate` bitwise for all five
     schemes in both reductions; the forms' and the collectives' ms;
     MultiRSU(n_rsus=1, mesh_aggregate=True) at Table 1, 2 rounds
     through `run` (launches counted: wagg 2 and dt_loss 2 a round) and
     2 through `run_campaign` (the graph, one rank), each round's global
     row within CROSS_MAX_ABS and CROSS_REL_UPDATE of the
     mesh_aggregate=False round from the same state; MultiRSU(n_rsus=2,
     mesh_aggregate=True) raises its actionable ValueError before any
     training;
   * ``[handover]``: 5 rounds of HandoverMultiRSU at the reference's
     defaults (2 RSUs of 1 km, 20 s rounds, stale discount 0.5, sync
     every 5) with ``codec="delta_int8"``, then one `region_view`:
     dt_loss = the chunks of the download groups padded to their
     buckets, q8_encode = q8_decode = the download groups, wagg = the
     upload groups + 1 (the sync at round 4) + 1 (`region_view`); fails
     without a handover and the sync;
   * ``[fedco]``: 2 rounds of the FedCo baseline (``aggregator="fedco"``:
     FedCo clients, FedAvg) under SingleRSU: wagg 2, dt_loss 0; each
     merged queue's first 5 x 512 rows against the k-vectors recomputed
     from the round's plan (FEDCO_KVEC_TOL), the rest bitwise the old
     queue, the key tree bitwise the global tree;
   * ``[probe]``: `encode` of the [main] final tree on the dataset's
     85/15 split (2,000 train, 1,000 test images), kNN and linear top-1,
     card against CPU features on 256 images (PROBE_FEAT_TOL), and both
     probes against the CPU on the card's features, image by image: kNN
     votes and the linear probe's weights and logits within their
     tolerances (PROBE_SIM_TOL, PROBE_EXP_REL, PROBE_LIN_REL), the same
     predicted class wherever the CPU's decision is not a near tie; the
     same on random unit features, where at most PROBE_SPREAD_TIES of
     1,000 images may be near ties.
7. Serve path: a fleet of 95 vehicles fetches from an
   ``RSUServer(start=False)`` over that store, driven by `drain_once`,
   with held rounds that give every reply kind (current, delta, full,
   shed); every applied reply must be bitwise the served tree, no request
   lost, and q8_decode launched once per delta hop applied (counters
   zeroed just before). Then a short threaded pass through
   `repro_torch.launch.serve.serve_campaign` (served/s, fetch p50/p99),
   and one more round with ``codec="delta"`` and with
   ``codec="identity"`` from the same state, bitwise equal on the card.

8. Zoo path (``[zoo]``): the RWKV6 serving path of the transformer zoo.
   * rwkv6 kernel against its plain chunked version
     (`ops.rwkv6_plain`) on the card, float32, atol 2e-4 on o and the
     state: at (BH, S, D) = (512, 2048, 64) with a per-row u (the
     full-width prefill's shape: 16 prompts x 32 heads), at a ragged
     S = 2043 and S = 37 with a nonzero state0 (the ragged states also
     against the sequential `ref.rwkv6_ref` on a few rows), and the
     projections' (B, S, H, D) layout read in place bitwise equal to the
     (BH, S, D) call. Timed with CUDA events and its device time beside
     its byte bound, with the kernel's registers and local (spill) bytes
     a thread and the blocks an SM holds
     (`kernels.rwkv6.kernel_attributes`: the kernel steps the recurrence
     with the state in registers, one block of 64 threads per row, so 4
     blocks an SM cover the 512 rows in one wave).
   * Cross-check: ``rwkv6-1.6b-smoke`` in float32 (parity mode), a
     prefill of B = 2, S = 37 then 4 decode steps through
     `launch.steps`, on the card and with ``device="cpu"``, logits and
     states at atol 2e-4; decode after the prefill equals the last
     position of a full forward of S + 1 tokens.
   * Full width: ``rwkv6-1.6b`` (24 layers, d_model 2048, 32 heads of 64,
     d_ff 7168, vocab 65536) with random bfloat16 weights from seed 0,
     through `repro_torch.launch.decode`: a prefill of 16 prompts x 2048
     tokens, then 64 greedy decode steps; the counters, zeroed just
     before each, must read rwkv6 24 (one launch per layer) for the
     prefill and 0 for the decode. The same prefill once more through
     the plain chunked version on the card holds the kernel in place:
     the first layer's state at atol 2e-4, and the last-position logits
     and final states within twice the divergence that a 2-ULP float32
     perturbation of the plain version's recurrence outputs causes in
     the same run (bfloat16 roundings grow through 24 random layers; see
     ZOO_BF16_FLOOR_X). Then the kernel and plain prefills once more with
     float32 weights and cache, at a relative L2 norm of 1e-3. Prints the
     prefill time, ms per decode step, decode tok/s, peak device memory,
     and the device time by op of one profiled prefill (with the
     kernel's share) and of four profiled decode steps.

9. Train path (``[train]``): the zoo's federated train step.
   * The differentiable rwkv6 (`ops.rwkv6`'s autograd.Function: the
     kernel forward, the plain chunked form differentiated all chunks at
     once in the backward): gradients of r, k, v, logw, u and state0
     against autograd through the plain chunk loop on the card, at (32,
     4096, 64) (one full-width sequence) and at a ragged S with a state,
     one kernel launch each, within RWKV6_GRAD_REL of each leaf's max.
   * The DT kernel's wide form (256 < D <= 8192, the zoo's features)
     against `ref.dt_loss_fwd_ref` at every DT_WIDE_SHAPES shape (the
     micro-batches of chip_smoke's `dt` steps, M = 8 at D = 1024-8192;
     the published micro-batches (16, 896), (16, 1024), (2, 4608), (1,
     7168), (1, 8192); the cohort form; M = 512, where the cluster's
     ranks split the keys and not D), DT_FWD_TOL, one launch of it and
     none of the narrow kernel, two calls bitwise equal, D = 8196 and
     8190 refused, 0 spill bytes; device ms at every (M, D) shape against
     the bound, beside the float32 cuBLAS q @ k.T (``gram_ms``) and a
     one-element fill (``floor_ms``); card ms at (8, 2048), a DT
     micro-batch.
   * Cross-check: ``rwkv6-1.6b-smoke`` in float32, one ``lm`` step (2
     micro-batches) and one ``dt`` step (S = 37, the last chunk ragged)
     on the card and with ``device="cpu"``: loss, every gradient leaf,
     params and momentum after the step (`train_cross_check` gives the
     tolerances).
   * Full width: ``rwkv6-1.6b``, random bfloat16 weights from seed 0,
     through `repro_torch.launch.train`'s functions: the first ``lm``
     micro-batch (1 x 4096) with the kernel forward against the plain
     forward, its loss and gradient norms within ZOO_BF16_FLOOR_X times
     the divergence of a 2-ULP perturbed plain forward in the same run;
     then ``lm`` (flsimco, sgdm) at 8 x 4096 in 8 micro-batches,
     TRAIN_LM_STEPS steps, and ``dt`` at 8 x 512 in one, TRAIN_DT_STEPS
     steps (each after a warm-up step): seconds a step, tok/s, finite
     losses, peak memory at most PEAK_GIB, launches a step (rwkv6 24 a
     micro-batch and view, dt_loss_wide one a micro-batch), and one
     step under torch.profiler with the device time of the
     ``rwkv6.recompute`` range (the plain backward) and the idle share.

10. Dense path (``[dense]``): the zoo's dense family, after [train]'s
   tensors are freed. The DT kernel's wide form is checked in [train]
   at D = 2048, 4608 and 8192 (`dt_wide_check`).
   * Cross-check: ``tinyllama-1.1b-smoke``, ``qwen2-0.5b-smoke`` and
     ``gemma2-27b-smoke`` in float32 on the card and with
     ``device="cpu"``: a prefill of 40 positions (past the smoke window
     of 32) and 4 decode steps with the float32 and with the int8 cache;
     one ``lm`` step in 2 micro-batches (S = 2048 for tinyllama: the
     flash Function and its backward) and one ``dt`` step, held as
     [train]'s cross-check holds its steps, but for the ``dt`` loss: it
     is held at the batch's limit from the DT kernel's specified lse_a
     and lse_b errors and the float32 rounding of w_a (DT_EXP_ULPS).
   * Full width: ``tinyllama-1.1b`` (22 layers) and ``qwen2-0.5b`` (24
     layers), random bfloat16 weights from seed 0, bfloat16 cache, 16
     prompts x 3008 tokens prefilled on the flash path into 3072 slots,
     64 greedy decode steps; no kernel launches; peak at most PEAK_GIB;
     each step's logits against a full forward at the same positions
     within DENSE_FLOOR_X times the divergence one bfloat16 step of the
     attention outputs causes in the same run; the prefill and 4 decode
     steps profiled. tinyllama's ``lm`` (flsimco, sgdm) at 8 x 4096 in 4
     micro-batches and ``dt`` at 8 x 512 (the wide DT form at D = 2048,
     one launch a step): seconds a step, tok/s, peak GiB, launches, one
     profiled step.
   * ``gemma2-27b`` and ``deepseek-67b`` at every published width with
     2 layers (gemma2: one local, one global): a 2 x 6080 prefill into
     6144 slots (past gemma2's 4096 window) and 64 decode steps, held as
     above, then one ``dt`` step at 8 x 512 (the wide DT form at D =
     4608 and 8192).

11. MoE path (``[moe]``): the zoo's MoE family, after [dense]'s tensors
   are freed.
   * Cross-check: ``olmoe-1b-7b-smoke`` and ``kimi-k2-1t-a32b-smoke``
     (its dense first layer and shared expert) in float32 on the card and
     with ``device="cpu"``: a prefill of 40 positions and 4 decode steps
     through `T.forward`, logits, aux losses and caches at ZOO_CROSS_TOL,
     every MoE call's top-k indices and drop masks equal; olmoe's ``lm``
     step as [train]'s cross-check.
   * One olmoe MoE layer at full width in float32: the routing of 16 x
     3008 tokens card vs CPU, a token's top-k set differing only within
     the float32 bound of the MoE comment block (the flips and the drops
     printed); `moe_block` on 1,024 of them, the rows whose routing and
     drops agree at ZOO_CROSS_TOL.
   * ``olmoe-1b-7b`` at full width (16 layers of 64 experts), random
     bfloat16 weights from seed 0: served as [dense] (16 x 3008 on the
     flash path into 3072 slots, 64 decode steps; no kernel launches;
     the dropped assignments of the prefill and of a decode step; one
     decode step under `no_implicit_transfers`), its decode on 2
     sequences at capacity factor E / k held against a full forward as
     [dense] holds its decode; ``lm`` (8 x 4096 in 4 micro-batches) and
     ``dt`` (8 x 512, one wide DT launch) with n_layers cut to 4.
     ``kimi-k2-1t-a32b`` at every published width with n_layers cut to
     2 (one dense, one MoE layer of 384 experts), served at 2 x 3008 +
     64. Every cut is printed with its reason.

12. Hybrid path (``[hybrid]``): the zoo's hybrid family, Hymba's
   selective-SSM branch beside sliding-window attention, after [moe]'s
   tensors are freed. No kernel of its own (the SSM is plain torch and
   cuBLAS); the DT kernel's wide form runs once a ``dt`` step at D =
   1600, and [train]'s `dt_wide_check` holds it at (8, 1600) and (512,
   1600).
   * Cross-check: ``hymba-1.5b-smoke`` in float32 on the card and with
     ``device="cpu"``: a train-mode forward of 36 positions, a prefill
     of 32 (the smoke window, the ring filled exactly) and 4 decode steps
     (the ring wraps), logits and every cache leaf (ring buffers, SSM
     and conv states) at ZOO_CROSS_TOL, positions bitwise; one ``lm``
     step in 2 micro-batches at S = 160 (the SSM's ragged split, 128 +
     32) and one ``dt`` step through `train_cross_check`.
   * One SSM layer at full width (d 1600, 3200 inner channels, state 16)
     in float32: 2 x 300 tokens (256 + 44) from given states, card vs
     CPU, the output and both states at ZOO_CROSS_TOL, the gradients
     through the recomputing backward (`layers._SSMScan`) of every leaf,
     the input and the starting state at TRAIN_LEAF_REL of each one's
     max.
   * ``hymba-1.5b`` at full width and depth (32 layers, 1.97e9
     parameters), random bfloat16 weights from seed 0: 16 prompts x 1024
     tokens fill the 1024-slot ring exactly (a prefill longer than the
     window loses keys, the reference's semantics), then 64 greedy decode
     steps, so the ring wraps from the first; one decode step under
     `no_implicit_transfers`; decode on HYBRID_CHECK_B sequences held
     against a full forward as [dense] holds its decode; the prefill and
     4 decode steps profiled with the ``ssm.scan`` range's device time.
     ``lm`` at 8 x 4096 in 8 micro-batches at full depth (its warm-up
     and profiled steps one micro-batch) and ``dt`` at 8 x 512 with
     n_layers cut to HYBRID_DT_LAYERS, both profiled with the
     ``ssm.scan`` and ``ssm.recompute`` ranges. Every cut is printed
     with its reason.

13. Audio path (``[audio]``): the zoo's audio family, SeamlessM4T's
   non-causal encoder over frame embeddings and its tanh-gated
   cross-attention over the encoder's context, after [hybrid]'s tensors
   are freed. No kernel of its own (attention is plain torch and
   cuBLAS); the DT kernel's wide form runs once a ``dt`` step at D =
   1024, and [train]'s `dt_wide_check` holds it at (8, 1024) and (512,
   1024). The reference starts every gate at 0, which keeps the context
   out of the logits, so every check sets the gates to CROSS_GATES.
   * Cross-check: ``seamless-m4t-large-v2-smoke`` in float32 on the card
     and with ``device="cpu"``: a train-mode forward with frames, a
     prefill of 32 with frames and 4 decode steps that read the ctx from
     the cache, logits and the cache leaves (rings and ctx) at
     ZOO_CROSS_TOL, decode against a full forward with the same frames;
     one ``lm`` step in 2 micro-batches and one ``dt`` step with frames
     through `train_cross_check`.
   * ``seamless-m4t-large-v2`` at full width and depth (24 encoder and
     24 decoder layers, 2.04e9 parameters), random bfloat16 weights from
     seed 0: 16 prompts x 3008 tokens with frames (16, 752, 1024) into
     3072 slots, 64 greedy decode steps; one decode step under
     `no_implicit_transfers`; decode on AUDIO_CHECK_B sequences held
     against a full forward with the same frames as [dense] holds its
     decode; ``lm`` at 8 x 4096 (frames 8 x 1024) in 8 micro-batches at
     full depth and ``dt`` at 8 x 512 with the decoder cut to
     AUDIO_DT_LAYERS layers; the prefill, 4 decode steps and an ``lm``
     micro-batch profiled with the ``audio.encoder``, ``audio.cross``
     and ``attention.ctx_kv`` ranges (the last: the cross blocks' k and v
     projections of the context, recomputed every decode step, as the
     reference's). Every cut is printed with its reason.

14. Vision-language path (``[vlm]``): the zoo's vlm family,
   Llama-3.2-Vision's decoder blocks stacked nested under super-layers,
   each closed by the gated cross block of [audio] over the projected
   patch embeddings, after [audio]'s tensors are freed. No kernel of its
   own; the DT kernel's wide form runs once a ``dt`` step at D = 8192,
   which [train]'s `dt_wide_check` holds at (8, 8192) and (512, 8192).
   Every check sets the gates to CROSS_GATES.
   * Cross-check: ``llama-3.2-vision-90b-smoke`` at VLM_NESTED (2
     super-layers of 2 decoder blocks, the rings 4 flat layers) in
     float32 on the card and with ``device="cpu"``: a train-mode forward
     with patches, a prefill of 32 with patches and 4 decode steps that
     read the projected patches from the cache, logits and the cache
     leaves at ZOO_CROSS_TOL, decode against a full forward with the same
     patches; one ``lm`` step in 2 micro-batches and one ``dt`` step
     through `train_cross_check`.
   * ``llama-3.2-vision-90b`` at full width (d 8192, 64 heads of 128 with
     8 KV heads, d_ff 28,672, 1,601 vision tokens of 1,280), random
     bfloat16 weights from seed 0, served with n_layers cut to 5 (one
     period: 4 decoder blocks and one cross block, 6.40e9 parameters): 8
     prompts x 3008 tokens with patches (8, 1601, 1280) into 3072 slots,
     64 greedy decode steps; one decode step under
     `no_implicit_transfers`; decode on VLM_CHECK_B sequences held
     against a full forward with the same patches; trained with n_layers
     cut to 2 (one decoder block and one cross block, the reference's
     reduced() layout at full width): ``lm`` at 8 x 4096 in 8
     micro-batches and ``dt`` at 8 x 512; the prefill, 4 decode steps and
     an ``lm`` micro-batch profiled with the ``vlm.vision_proj``,
     ``vlm.cross`` and ``attention.ctx_kv`` ranges. Every cut is printed
     with its reason.

15. Dry run (``[dryrun]``, after the zoo's mesh phase): the port's
   launch/dryrun.py in two subprocesses, started before [zoo_mesh] and
   run beside it, so that their fake process groups never meet the real
   groups of [mesh] and [zoo_mesh] (they compute nothing on the card:
   fake tensors on a ``cuda`` mesh):
   ``python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape
   prefill_32k --mesh single`` (256 fake ranks of the (16, 16) mesh) to
   a temporary ``--out``, whose record must be ok (its FLOPs, collective
   bytes and counts, argument, temp and peak bytes printed), and a
   (1, 1) fake trace of a DRYRUN_PREFILL prefill. Meanwhile tinyllama
   is drawn on the card (bf16, seed 0) and prefills DRYRUN_PREFILL
   tokens (3,072 is a multiple of 1,024: the flash path): `rank_bytes`
   on a (1, 1) `ShapeMesh` must equal the bytes of the params and tokens
   on the card, and the trace's ``output_bytes`` the bytes of the logits
   and cache the prefill returned, exactly (both are counts); the
   estimate ``argument_bytes + temp_bytes`` is printed beside the
   measured bytes and growth of `torch.cuda.max_memory_allocated`.

The q8 kernels are held against their plain versions in phase 2, at
(5, Ppad), (3, Ppad), (2, Ppad) and (1, Ppad), Ppad = 11,506,688 (the
cohort, the groups of MultiRSU and the handover, a snapshot): codes,
scales, residuals and
the decode bitwise equal; a ragged P (through `ops`) bitwise equal to the
aligned call's columns; an all-zero block decodes to zeros. The library
yardstick of the decode is ``torch.mul(codes.view(N, -1, 256),
scales[..., None])``; the encode has none. Their ``device_ms`` is taken at
both shapes (``device_ms_1``: at (1, Ppad)).

The ``kernels`` JSON line lists wagg, dt_loss, q8_encode, q8_decode,
rwkv6 and dt_loss_wide (the DT kernel's wide form, launched by the train
path), each with its launches on the path that runs it (``paths``: its
launches on every path: main, comms, batched, resume, engine (its
graph campaigns), multi, mesh, handover, fedco, zoo, train (the timed
steps of both objectives), dense (the timed dense steps and serving
runs), moe, hybrid, audio and vlm (likewise)),
``ms`` and ``device_ms``. A ``[time]`` line gives the script's seconds.
The last three lines of standard output are the
``kernels`` JSON line, the nvidia-smi line, and ``{"ok": true,
"device": {...}}``. On any
failure, or without a CUDA card, or outside a checkout, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
F32_FLOP_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
TF32_FLOP_PER_S = 495e12    # H100 SXM TF32 on the tensor cores (dense)

WAGG_P = 11_506_624         # ResNet-18-CIFAR params + BN stats
BQ = 256                    # q8 block: parameters sharing one scale
Q8_PPAD = -(-WAGG_P // BQ) * BQ
WAGG_TOL = 1e-5
DT_FWD_TOL = 2e-5
DT_GRAD_TOL = 1e-5
DT_TAUS = ((0.1, 1.0), (0.07, 1.0))   # the paper's pair, and a sharper tau_a
# Card vs CPU after one round. cuDNN and the CPU sum convolutions in
# different orders, and a ReLU input within that rounding of 0 can switch
# sides; one SGD step at lr 0.9 carries it into the tree. Held as in
# tests/test_torch_round.py: loss, max abs tree difference, and the norm
# of the difference relative to the norm of the round's update.
CROSS_LOSS_TOL = 1e-4
CROSS_MAX_ABS = 1e-2
CROSS_REL_UPDATE = 2e-2
# rwkv6 kernel vs its plain chunked version (and the sequential oracle),
# float32: sums of 16-80 terms and the chunk's prefix sums in another
# order (a few ULP in the exponents); the reference's own tolerance for
# this recurrence (tests/test_kernels.py)
RWKV6_TOL = 2e-4
ZOO_CROSS_TOL = 2e-4        # smoke config, float32, card vs CPU
# Full width, kernel prefill against the plain one. In bfloat16 the two
# differ by a few float32 ULP in each layer's recurrence output, which
# flips the bfloat16 rounding of some elements; with random weights the
# flips grow layer by layer (a float32-ULP perturbation of the plain
# version alone moves the final logits by about 10% in relative L2). So
# in bfloat16 the first layer's state (identical inputs on both sides) is
# held at RWKV6_TOL, and the last logits and final states at most
# ZOO_BF16_FLOOR_X times the divergence of the plain prefill from itself
# with its recurrence outputs perturbed by ZOO_ULP_EPS (2 float32 ULP),
# measured in the same run. In float32 the same comparison is held at
# ZOO_F32_REL: a few ULP grown over 24 layers.
ZOO_BF16_FLOOR_X = 2.0
ZOO_ULP_EPS = 2.0 ** -22
ZOO_F32_REL = 1e-3
ZOO_B, ZOO_S, ZOO_DECODE = 16, 2048, 64
RWKV_H, RWKV_D = 32, 64
# [train]: the full-width runs, (batch, seq_len, n_micro). lm: train_4k's
# length, the batch cut from 256 to 8, one sequence a micro-batch (41.7
# GiB peak; two a micro-batch peak at 55.4 GiB alone and ran out of the
# card's memory after the earlier phases; H100 80GB HBM3, 700 W); dt:
# micro-batches of at least 8 rows (the loss's in-batch negatives) and
# two forwards each, S cut to 512 to stay under PEAK_GIB.
TRAIN_LM, TRAIN_LM_STEPS = (8, 4096, 8), 2
TRAIN_DT, TRAIN_DT_STEPS = (8, 512, 1), 2
TRAIN_S, TRAIN_D = 4096, 2048
# [train]: the rwkv6 Function's gradients against autograd through the
# plain chunk loop on the card, of each leaf's max: the same sums taken
# in another order (the chunk states all at once against one by one)
# over 4096 steps
RWKV6_GRAD_REL = 2e-5
# [train]: the smoke config's step card vs CPU, float32: the CPU tests'
# tolerances (loss 1e-6 relative, leaves 2e-5 of their max); for the dt
# step, widened by the DT kernel's own float32 difference as it reaches
# the gradient (`train_cross_check`)
TRAIN_LOSS_REL = 1e-6
TRAIN_LEAF_REL = 2e-5
# [probe]: card against CPU features of the same tree on 256 images
# (unit-norm features; cuDNN and the CPU sum convolutions in other orders)
PROBE_FEAT_TOL = 1e-4
# [probe]: the probes on the card against the CPU on the same features.
# Similarities (unit vectors, 512 float32 products summed in other
# orders): max abs at most PROBE_SIM_TOL. The kNN votes exp(sim / 0.1)
# then differ by 2 * delta / 0.1 relative plus PROBE_EXP_REL (float32
# exp rounds differently on the two); the linear probe's weights and
# logits (80 SGD steps) within PROBE_LIN_REL of their largest value.
PROBE_SIM_TOL = 1e-5
PROBE_EXP_REL = 1e-6
PROBE_LIN_REL = 1e-4
# [probe]: the same check on random unit features, whose similarities
# spread (std 1/sqrt(512)): at most this many near-tie images of 1,000,
# so the check there covers nearly every image (the trained features
# point almost one way and most of their images are near ties)
PROBE_SPREAD_TIES = 10
# [fedco]: the merged queue's first rows against the k-vectors recomputed
# from the round's plan (the key encoder's forward once more on the card)
FEDCO_KVEC_TOL = 1e-5
# [batched]: the peak device memory a Table-1 round may take on the 80 GB
# card (torch.cuda.max_memory_allocated); the chunk of the batched cohort
# step (core/clients.py CLIENTS_PER_CHUNK) is sized for it
PEAK_GIB = 64.0
# [dense]: the dense family. Card vs CPU, float32 smoke configs: logits
# and caches at ZOO_CROSS_TOL; with the int8 cache a code may land one
# step apart where its float32 value sits at a rounding boundary, which
# moves one k or v element by its row's absmax / 127, so logits there at
# DENSE_INT8_TOL (tests/test_torch_dense.py's INT8_LOGIT_TOL).
DENSE_SMOKE = ("tinyllama-1.1b", "qwen2-0.5b", "gemma2-27b")
DENSE_CROSS_S = 40          # prefill past the smoke configs' window of 32
# The dense smoke configs' dt step card vs CPU: a row's loss is
# -(w_b / w_a) log p_a, w_a = 1 - exp(log p_a), evaluated in float32 on
# each side. Where the positive takes nearly all of the softmax at tau_a,
# exp(log p_a) lies just below 1, and its rounding (two exps, each
# within 2 ulp: CUDA's expf; the CPU's float32 exp within 1; DT_EXP_ULPS
# of 2^-24 in all) moves w_a, and the row's loss, by DT_EXP_ULPS * 2^-24
# / w_a relative. The
# kernel's lse_a and lse_b are held to DT_FWD_TOL of the plain version's
# on the card's features: lse_a moves the loss by at most DT_FWD_TOL
# relative (loss = w_b r(x), x = -log p_a, r(x) = x / (1 - e^-x), slope
# at most 1, r at least 1), lse_b by DT_FWD_TOL (1 - w_b) / w_b. So a row
# is held at TRAIN_LOSS_REL plus those, and the mean loss at their mean
# weighted by the rows' losses (`_dt_kernel_spread`). [train]'s rwkv6 dt
# step keeps TRAIN_LOSS_REL.
DT_EXP_ULPS = 4
DENSE_INT8_TOL = 1e-2
# Full width: 16 prompts of 3008 tokens and 64 decode steps, a cache of
# 3072 slots (a multiple of the flash path's key chunk, so the prefill
# takes the flash path; at 2048 + 64 the direct path would hold (16, 32,
# 2048, 2112) float32 scores, 8.9 GB a layer). The decode steps' logits
# are held against a full forward at DENSE_FLOOR_X times the divergence
# a DENSE_BF16_EPS perturbation of its attention outputs causes, in the
# same run, as ZOO_BF16_FLOOR_X holds the rwkv6 prefill. The decode
# steps take the direct path, which rounds its probabilities to bfloat16
# before the product with v; the forward's flash path keeps them in
# float32. So an attention output may move by up to one bfloat16 step
# (relative 2^-8 to 2^-7) between the two: the perturbation scales each
# bfloat16 output by (1 +- 2^-8), a seeded random sign an element, which
# moves the elements it reaches by one step and flips the roundings that
# follow, layer after layer.
DENSE_FULL = ("tinyllama-1.1b", "qwen2-0.5b")
DENSE_SERVE = (16, 3008, 64)
DENSE_BF16_EPS = 2.0 ** -8
DENSE_FLOOR_X = 2.0
# tinyllama-1.1b train steps: lm at train_4k's length, the batch cut to
# 8, two sequences a micro-batch (pick_n_micro's 4e9 budget would give
# one micro-batch of 8 x 4096, which does not fit); dt as [train]'s
DENSE_LM, DENSE_LM_STEPS = (8, 4096, 4), 1
DENSE_DT, DENSE_DT_STEPS = (8, 512, 1), 1
# gemma2-27b and deepseek-67b at every published width, n_layers cut to
# 2 (about 2.31e9 and 3.06e9 parameters, 4.6 and 6.1 GB in bfloat16):
# 2 prompts of 6080 tokens + 64 decode steps (6144 slots, past gemma2's
# 4096 window, so its local layer masks)
DENSE_CUT_ARCHS = ("gemma2-27b", "deepseek-67b")
DENSE_CUT_LAYERS = 2
DENSE_CUT = (2, 6080, 64)

# [moe]: the MoE family. Card vs CPU, float32 smoke configs: logits, aux
# losses and caches at ZOO_CROSS_TOL, the routing (top-k indices and drop
# masks) of every MoE call equal. At full width, one olmoe MoE layer in
# float32 (TF32 off) routes MOE_SERVE's 48,128 tokens on the card and on
# the CPU from the same inputs: a token's top-k set may differ only where
# the CPU's gap between its k-th and (k+1)-th logits lies within what the
# two sides' float32 roundings can move: each logit is a dot product of
# length d, within gamma_d * sum_i |x_i w_ie| of the exact value whatever
# the summation order (gamma_d = d u / (1 - d u), u = 2^-24), on each
# side, so a pair can swap at a gap of 4 gamma_d max_e sum_i |x_i w_ie|;
# the softmax adds 16 u (1 + l_max - l_(k+1)) (the shift by the max and
# the exp and division, a few u each, on each side). Outputs of the rows
# whose routing and drops agree are held at ZOO_CROSS_TOL on MOE_OUT_T
# tokens (the CPU's expert products take seconds a thousand tokens).
MOE_ARCHS = ("olmoe-1b-7b", "kimi-k2-1t-a32b")
MOE_OUT_T = 1024
# olmoe-1b-7b at full width, served as DENSE_SERVE (16 x 3008 into 3072
# slots, 64 decode steps); its decode held against a full forward on
# MOE_CHECK_B sequences at capacity factor E / k (C = T: nothing drops,
# as the reference's own test raises the factor), at DENSE_FLOOR_X times
# a one-bfloat16-step floor, as [dense].
MOE_SERVE = (16, 3008, 64)
MOE_CHECK_B = 2
# olmoe training, n_layers cut from 16 to MOE_TRAIN_LAYERS: at 16 layers
# the step holds bf16 params and momentum, float32 accumulators and a
# micro-batch's bf16 gradients of 6.9e9 parameters, about 69 GB before
# activations; lm and dt as tinyllama's in [dense]
MOE_TRAIN_LAYERS = 4
MOE_LM, MOE_LM_STEPS = (8, 4096, 4), 1
MOE_DT, MOE_DT_STEPS = (8, 512, 1), 1
# kimi-k2-1t-a32b at every published width, n_layers cut from 61 to 2
# (the dense first layer and one MoE layer of 384 experts: 1.96e10
# parameters, 39 GB in bfloat16; each further MoE layer adds 33.8 GB);
# served only (a training step's state would not fit)
MOE_CUT_ARCH = "kimi-k2-1t-a32b"
MOE_CUT_LAYERS = 2
MOE_CUT = (2, 3008, 64)

# [hybrid]: hymba-1.5b. Card vs CPU, the float32 smoke config: logits and
# every cache leaf at ZOO_CROSS_TOL, the train steps as [dense]'s. One
# SSM layer at full width, float32: HYBRID_SSM_S tokens (two whole
# 128-chunks and a ragged 44), outputs and states at ZOO_CROSS_TOL,
# gradients at TRAIN_LEAF_REL of each leaf's max (the smoke steps'
# limit).
HYBRID_ARCH = "hymba-1.5b"
HYBRID_SSM_S = 300
# Served at full width and depth: prefill_32k and decode_32k cut in batch
# and length to 16 prompts of 1024 tokens, which fill the 1024-slot ring
# of the sliding window exactly (a longer prompt loses keys of its
# earlier queries' windows and, through the SSM, changes even the last
# logits: the reference's semantics), and 64 decode steps; the decode of
# HYBRID_CHECK_B sequences held against a full forward at DENSE_FLOOR_X
# times the one-bfloat16-step floor.
HYBRID_SERVE = (16, 1024, 64)
HYBRID_CHECK_B = 2
# Training, reckoned from the shapes: bf16 params and momentum, a
# micro-batch's bf16 gradients and float32 accumulators of 1.97e9
# parameters take 19.7 GB; each layer keeps about 225 KB of activations a
# token (the norms' float32 copies, the SSM branch's float32 dt, x1 and
# output, the gated MLP), so lm at 8
# x 4096 in 8 micro-batches (one sequence each) adds 29.5 GB at full
# depth: about 50 GiB with the logits and the backward's transients. dt
# at 8 x 512 in one micro-batch (its 8 rows are the loss's in-batch
# negatives) runs two views: 8,192 tokens a layer plus the direct
# attention's two (8, 5, 5, 512, 512) float32 score tensors a view, 2.7
# GB a layer, about 104 GB at full depth; n_layers is cut to
# HYBRID_DT_LAYERS, half the depth (about 46 GB reckoned; 12 layers
# peaked at 40.67 GiB on an H100 80GB HBM3 at 700 W, about 3.3 GiB a
# layer, so 16 take about 54 GiB). lm's warm-up and profiled steps run
# one micro-batch (`_train_run(one_micro=True)`): a full step takes about
# 22 s and half a million launches.
HYBRID_LM, HYBRID_LM_STEPS = (8, 4096, 8), 1
HYBRID_DT, HYBRID_DT_STEPS = (8, 512, 1), 1
HYBRID_DT_LAYERS = 16

# [audio]: seamless-m4t-large-v2. The reference starts every cross
# block's gate_attn and gate_mlp at 0, so tanh(0) = 0 keeps the encoder
# and the cross-attention out of the logits and their gradients: a check
# at the init gates passes with a wrong or missing encoder. Every check
# of the phase (and of [vlm], whose cross blocks are the same) sets them
# to CROSS_GATES first (`_set_gates`). Card vs CPU, the float32 smoke
# config: logits and every cache leaf (the rings and the ctx) at
# ZOO_CROSS_TOL, the train steps as [dense]'s.
AUDIO_ARCH = "seamless-m4t-large-v2"
CROSS_GATES = (0.5, -0.4)   # (gate_attn, gate_mlp) in every cross block
# Served at full width and depth as DENSE_SERVE (prefill_32k and
# decode_32k cut in batch and length): 16 prompts of 3008 tokens with
# frames (16, 752, 1024) (max(S // 4, 8) rows at the prompt's S) into
# 3072 slots (the decoder's self-attention on the flash path; the cross
# blocks' 752 context rows, not a multiple of 1024, on the direct path),
# 64 decode steps; the decode of AUDIO_CHECK_B sequences held against a
# full forward with the same frames at DENSE_FLOOR_X times the
# one-bfloat16-step floor.
AUDIO_SERVE = (16, 3008, 64)
AUDIO_CHECK_B = 2
# Training, reckoned from the shapes: bf16 params and momentum, a
# micro-batch's bf16 gradients and float32 accumulators of 2.04e9
# parameters take 20.4 GB. lm at 8 x 4096 in 8 micro-batches (one
# sequence and its 1024 frames each): a decoder layer with its cross
# block keeps about 0.6 GB (two MLPs' (4096, 8192) bf16 hidden states,
# 268 MB; four norms' float32 copies, about 200 MB; the two flash
# attentions' q, k, v and float32 o), an encoder layer about 0.2 GB (its
# direct attention's (16, 1024, 1024) float32 probabilities, twice),
# 19.8 GB at full depth, plus 4.2 GB of float32 logits (V = 258,048) and
# their backward's: about 50 GB, so full depth. dt at 8 x 512 (frames 8
# x 128) in one micro-batch runs two views, and the direct path keeps
# two (8, 16, 512, 512) float32 probability tensors a self-attention:
# about 1.9 GB a decoder layer for both views, 46 GB at full depth
# beside the state, over PEAK_GIB; n_layers (the decoder's) is cut to
# AUDIO_DT_LAYERS, the encoder kept whole (about 48 GiB reckoned). lm's
# warm-up and profiled steps run one micro-batch, as [hybrid]'s.
AUDIO_LM, AUDIO_LM_STEPS = (8, 4096, 8), 1
AUDIO_DT, AUDIO_DT_STEPS = (8, 512, 1), 1
AUDIO_DT_LAYERS = 16
AUDIO_RANGES = ("audio.encoder", "audio.cross", "attention.ctx_kv")

# [vlm]: llama-3.2-vision-90b (100 layers, a gated cross block every 5th,
# 9.07e10 parameters, 181 GB in bf16: one card holds no full depth).
# Card vs CPU at VLM_NESTED, the smoke config with 2 super-layers of 2
# decoder blocks (the reduced() layout has one of each and would not show
# the order of the nested walk or of the flat cache index), float32, gates
# CROSS_GATES, the limits of [audio]. Served at full width with n_layers
# cut to VLM_SERVE_LAYERS, one period (4 decoder blocks and one cross
# block, 6.40e9 parameters, 12.8 GB): 8 prompts x 3008 tokens with patches
# (8, 1601, 1280) into 3072 slots (the decoder blocks on the flash path;
# the cross blocks' 1601 rows, not a multiple of 1024, on the direct
# path), 64 decode steps; reckoned peak 12.8 GB of weights + about 35 GB
# for the cross block's direct path ((8, 64, 3008, 1601) float32 scores,
# 9.9 GB a tensor, about 3.5 alive) + a 6.3 GB flash tile, about 55 GB,
# so 8 prompts (16 would pass PEAK_GIB). Trained with n_layers 2 and a
# cross block every 2nd layer (the reference's reduced() layout at full
# width: one decoder block and one cross block, 3.84e9 parameters): at 5
# layers the step state alone (bf16 params, momentum and a micro-batch's
# gradients, float32 accumulators: 10 bytes a parameter) is 64 GB, over
# PEAK_GIB; at 2 layers 38.4 GB. lm at 8 x 4096 in 8 micro-batches adds
# 2.1 GB float32 logits a micro-batch and about 4 such tensors in their
# backward, and the cross block's direct path keeps two (64, 4096, 1601)
# float32 tensors of 1.7 GB: about 55 GB reckoned. dt at 8 x 512 in one
# micro-batch: two views' (8, 64, 512, 1601) float32 probabilities, 1.7
# GB a tensor, about 50 GB reckoned. lm's warm-up and profiled steps take
# one micro-batch, as [audio]'s.
VLM_ARCH = "llama-3.2-vision-90b"
VLM_NESTED = dict(n_layers=6, cross_attn_period=3)
VLM_SERVE, VLM_SERVE_LAYERS = (8, 3008, 64), 5
VLM_CHECK_B = 2
VLM_TRAIN = dict(n_layers=2, cross_attn_period=2)
VLM_LM, VLM_LM_STEPS = (8, 4096, 8), 1
VLM_DT, VLM_DT_STEPS = (8, 512, 1), 1
VLM_RANGES = ("vlm.vision_proj", "vlm.cross", "attention.ctx_kv")

# [zoo_mesh]: the zoo's mesh mode (launch/steps.py with a mesh: params,
# momentum, batches and caches as DTensors placed by launch/sharding.py,
# activations under its rules) at world size 1 over NCCL, a (data=1,
# model=1) zoo mesh, held bitwise against the same steps without a mesh
# from the same params and inputs: tinyllama-1.1b's dt step (the DT
# kernel's wide form on the features gathered over the batch axes, one
# launch), olmoe-1b-7b's lm step with n_layers cut to MOE_TRAIN_LAYERS
# (as [moe]), and each model's prefill of ZOO_MESH_SERVE[0] x [1] tokens
# and ZOO_MESH_SERVE[2] greedy decode steps (the logits and the caches).
# Both sides run under torch.use_deterministic_algorithms, since the
# MoE's backward accumulates with index_put, whose default CUDA kernel
# adds with atomics, so two one-device runs need not agree bitwise.
# The other four families, at full width with their depth cut
# (ZOO_MESH_CUTS; rwkv6-1.6b at its full 24 layers), each an lm step of
# ZOO_MESH_FAMILY_LM (8 x 1024, rwkv6 4 x 1024; seamless with frames
# (8, 256, 1024), llama-3.2-vision with patches (8, 1601, 1280)) and the
# same serve run (the context drawn with the prompts), the cross gates
# at CROSS_GATES:
# rwkv6's mesh path launches the rwkv6 kernel on its (batch, head)
# shards, once a layer of every lm step and prefill (24 each), none in
# decode, as the one-card path does. Memory (H100 80GB HBM3, 700 W):
# the one-card steps read the mesh's local shards (at world size 1 the
# whole leaves; `shard_params` copies them), the allocator's cache is
# given back before each row's mesh calls, and for ZOO_MESH_HOST the
# one-card step's result waits on the host meanwhile. rwkv6's mesh step
# at 8 x 1024 (57.94-63.48 GiB at its peak alone) ran the card out of
# memory late in the script twice, with 16.6-20.5 GiB of the cache free
# in pieces, so it takes 4 x 1024 (in one micro-batch: 24 launches).
# llama-3.2-vision's 2 layers hold 3.84e9 parameters: bf16 params,
# float32 accumulators, bf16 gradients and the new params and momentum
# take 46 GB; in one micro-batch its cross block's direct path ((8, 64,
# 1024, 1601) float32 scores, 3.4 GB a tensor) and the (8, 1024,
# 129024) float32 logits ran the card out of memory, in 2 it peaked at
# 69.15 GiB alone and in 4 at 56.77, so its step takes 8 micro-batches
# (one sequence each, as [vlm]'s lm). seamless's
# (8, 1024, 258048) float32 logits (8.5 GB) and their backward peaked at
# 60.20 GiB alone: 2 micro-batches.
# [dryrun]: launch/dryrun.py's record of DRYRUN_ARCH's prefill_32k on
# the (16, 16) fake world, and a one-card prefill of DRYRUN_PREFILL
# (batch, tokens) beside its (1, 1) fake trace; each subprocess is given
# at most DRYRUN_TIMEOUT_S
DRYRUN_ARCH = "tinyllama-1.1b"
DRYRUN_PREFILL = (16, 3072)
DRYRUN_TIMEOUT_S = 300
_ONE_CARD_TRACE = (
    "import json, sys\n"
    "from repro_torch.configs import get_config\n"
    "from repro_torch.configs.base import InputShape\n"
    "from repro_torch.launch import dryrun as dr\n"
    "b, s = int(sys.argv[3]), int(sys.argv[4])\n"
    "rec = dr.trace_step(get_config(sys.argv[2]),\n"
    "                    InputShape('prefill', s, b, 'prefill'), (1, 1))\n"
    "with open(sys.argv[1], 'w') as f:\n"
    "    json.dump(rec, f)\n")

ZOO_MESH_DT = (8, 512, 1)
ZOO_MESH_LM = MOE_LM
ZOO_MESH_FAMILY_LM = {"*": (8, 1024, 1), "rwkv6-1.6b": (4, 1024, 1),
                      "seamless-m4t-large-v2": (8, 1024, 2),
                      "llama-3.2-vision-90b": (8, 1024, 8)}
ZOO_MESH_SERVE = (8, 1024, 16)
ZOO_MESH_HOST = ("llama-3.2-vision-90b",)
ZOO_MESH_ARCHS = ("tinyllama-1.1b", "olmoe-1b-7b", "rwkv6-1.6b",
                  "hymba-1.5b", "seamless-m4t-large-v2",
                  "llama-3.2-vision-90b")
ZOO_MESH_CUTS = {"olmoe-1b-7b": dict(n_layers=MOE_TRAIN_LAYERS),
                 "hymba-1.5b": dict(n_layers=4),
                 "seamless-m4t-large-v2": dict(n_layers=4,
                                               n_encoder_layers=4),
                 "llama-3.2-vision-90b": VLM_TRAIN}


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# CUPTI may hand back a window with no device record at all (seen once in
# a PR 29 run: every launch of a kernel that the windows before it had
# recorded): the window is profiled again, at most this many times in
# all, and a kernel that no window records still fails
PROFILE_WINDOWS = 3


def _profiled(work):
    """(work()'s result, key_averages()) of `work` under torch.profiler,
    CPU and CUDA activity, synchronised before and after."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = work()
        torch.cuda.synchronize()
    return out, prof.key_averages()


def _device_ms(fn, kernel: str, iters: int = 50) -> float:
    """The kernel's own device time a launch, in ms, apart from its
    wrapper's host work: `fn()` (one launch of the kernel) `iters` times
    under torch.profiler, then the self device time of the device events
    whose name holds `kernel`, summed and divided by their count (CUPTI's
    kernel start and end stamps, not the host clock; the trace may drop a
    few records, so the count is the trace's, and a window with none is
    profiled again, PROFILE_WINDOWS in all). Raises unless a trace holds
    between 1 and `iters` such launches with device time."""
    from torch.autograd import DeviceType

    fn()                                   # warm-up, outside the trace

    def work():
        for _ in range(iters):
            fn()
    for _ in range(PROFILE_WINDOWS):
        _, events = _profiled(work)
        hits = [e for e in events if e.device_type == DeviceType.CUDA
                and kernel in e.key]
        n = sum(e.count for e in hits)
        total_us = sum(e.self_device_time_total for e in hits)
        if n:
            break
        print(f"[profiler] no device record of {kernel!r} in a window of "
              f"{iters} calls; profiling again", flush=True)
    if not 0 < n <= iters or not total_us > 0:
        raise AssertionError(f"profiler: {n} launches of {kernel!r} with "
                             f"{total_us} us of device time, expected 1 to "
                             f"{iters} launches")
    return total_us / n / 1e3


def _device_ms_all(fn, iters: int = 50) -> float:
    """The device time of everything `fn()` launches, in ms a call: the
    self device time of all device events of `iters` calls under
    torch.profiler over `iters` (a yardstick that is not one kernel:
    cuBLAS may split a product into several). Raises on an empty trace."""
    from torch.autograd import DeviceType

    fn()                                   # warm-up, outside the trace

    def work():
        for _ in range(iters):
            fn()
    for _ in range(PROFILE_WINDOWS):
        _, events = _profiled(work)
        total_us = sum(e.self_device_time_total for e in events
                       if e.device_type == DeviceType.CUDA)
        if total_us > 0:
            break
        print(f"[profiler] no device record in a window of {iters} calls; "
              f"profiling again", flush=True)
    if not total_us > 0:
        raise AssertionError("profiler: no device time in the trace")
    return total_us / iters / 1e3


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _bound(nbytes: float, flops: float, flop_rate: float = F32_FLOP_PER_S):
    b_bytes, b_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return 1e3 * max(b_bytes, b_ops), ("bytes" if b_bytes >= b_ops
                                       else "operations")


def kernel_phase(dev):
    import torch

    from repro_torch.core.dt_loss import dt_loss_matrix
    from repro_torch.kernels import dt_loss as dt_kernel
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(0)
    rows = []

    # -- wagg --------------------------------------------------------------
    m, n_pad = 5, 8
    x = torch.randn((m, WAGG_P), generator=g, device=dev)
    w = torch.softmax(torch.randn(m, generator=g, device=dev), 0)
    ones = torch.ones(m, device=dev)
    mask = torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0], device=dev)
    errs = []
    out = ops.wagg_flat(x, w)
    errs.append(_max_err(out, ref.wagg_ref(x, w)))
    out_m = ops.wagg_flat(x, w, mask)
    errs.append(_max_err(out_m, ref.wagg_ref(x, w, mask)))
    xp = torch.cat([x, x[-1:].expand(n_pad - m, -1)]).contiguous()
    wp = torch.cat([w, torch.zeros(n_pad - m, device=dev)])
    mp = torch.cat([ones, torch.zeros(n_pad - m, device=dev)])
    out_p = ops.wagg_flat(xp, wp, mp)
    out_u = ops.wagg_flat(x, w, ones)
    torch.cuda.synchronize()
    if not (torch.equal(out_p, out_u) and torch.equal(out_u, out)):
        raise AssertionError("wagg: masked padded call is not bitwise equal "
                             "to the unpadded call")
    err = max(errs)
    if not err <= WAGG_TOL:
        raise AssertionError(f"wagg: max abs err {err} > {WAGG_TOL}")
    del xp
    # P % 4 == 1: rows are no longer 16-byte aligned, so every column
    # takes the kernel's column-by-column branch, with the same sums
    xr = x[:, :WAGG_P - 3].contiguous()
    out_r = ops.wagg_flat(xr, w)
    torch.cuda.synchronize()
    if not torch.equal(out_r, out[:WAGG_P - 3]):
        raise AssertionError("wagg: ragged call (P % 4 == 1) is not bitwise "
                             "equal to the aligned call")
    del xr
    ms = _time_ms(lambda: ops.wagg_flat(x, w, ones))
    dev_ms = _device_ms(lambda: ops.wagg_flat(x, w, ones), "wagg_kernel")
    plain_ms = _time_ms(lambda: ref.wagg_ref(x, w, ones))
    lib_ms = _time_ms(lambda: torch.matmul(w, x))
    bound_ms, bound_by = _bound(4 * (m * WAGG_P + WAGG_P + 2 * m),
                                2 * m * WAGG_P)
    rows.append({"name": "wagg", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/wagg.cu",
                 "replaces": "src/repro/kernels/wagg.py:26",
                 "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": lib_ms})
    print(f"[kernels] wagg m={m} P={WAGG_P}: max_abs_err={err:.3e} "
          f"padded==unpadded, ragged==aligned bitwise; kernel {ms:.4f} ms "
          f"(device {dev_ms:.4f} ms), plain {plain_ms:.4f} ms, w@x "
          f"{lib_ms:.4f} ms", flush=True)
    del x

    # -- dt_loss -----------------------------------------------------------
    errs = []
    for M in (512, 500, 513):
        q = torch.nn.functional.normalize(
            torch.randn((M, 128), generator=g, device=dev), dim=-1)
        k = torch.nn.functional.normalize(
            torch.randn((M, 128), generator=g, device=dev), dim=-1)
        for ta, tb in DT_TAUS:
            got = ops.dt_loss_fwd(q, k, ta, tb)
            want = ref.dt_loss_fwd_ref(q, k, ta, tb)
            fwd_err = max(_max_err(a, b) for a, b in zip(got, want))
            if not fwd_err <= DT_FWD_TOL:
                raise AssertionError(f"dt_loss fwd M={M} taus=({ta}, {tb}): "
                                     f"{fwd_err} > {DT_FWD_TOL}")
            again = ops.dt_loss_fwd(q, k, ta, tb)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"dt_loss M={M}: two calls are not "
                                     f"bitwise equal")
            q1, k1 = q.clone().requires_grad_(), k.clone().requires_grad_()
            q2, k2 = q.clone().requires_grad_(), k.clone().requires_grad_()
            gq1, gk1 = torch.autograd.grad(ops.dt_loss(q1, k1, ta, tb),
                                           (q1, k1))
            gq2, gk2 = torch.autograd.grad(dt_loss_matrix(q2, k2, ta, tb),
                                           (q2, k2))
            grad_err = max(_max_err(gq1, gq2), _max_err(gk1, gk2))
            if not grad_err <= DT_GRAD_TOL:
                raise AssertionError(f"dt_loss grad M={M} taus=({ta}, {tb}): "
                                     f"{grad_err} > {DT_GRAD_TOL}")
            errs.append(max(fwd_err, grad_err))
            print(f"[kernels] dt_loss M={M} D=128 taus=({ta}, {tb}): fwd err "
                  f"{fwd_err:.3e}, grad err {grad_err:.3e}, two calls "
                  f"bitwise equal", flush=True)
    errs += _dt_cohort_checks(dev, g)
    # timed at the main path's shapes: a chunk of CLIENTS_PER_CHUNK
    # clients (the row's numbers), one client, and a cohort of 5
    from repro_torch.core.clients import CLIENTS_PER_CHUNK
    D = 128
    timed = {}
    for C in sorted({1, CLIENTS_PER_CHUNK, 5}):
        q = _unit_rows(g, dev, (C, 512, D))
        k = _unit_rows(g, dev, (C, 512, D))
        timed[C] = (_time_ms(lambda: ops.dt_loss_fwd(q, k, 0.1, 1.0),
                             iters=200),
                    _device_ms(lambda: ops.dt_loss_fwd(q, k, 0.1, 1.0),
                               "dt_fwd", iters=200),
                    _time_ms(lambda: ref.dt_loss_fwd_cohort_ref(q, k, 0.1,
                                                                1.0),
                             iters=50),
                    _dt_bound(C, 512, D))
        ms, dev_ms, plain_ms, (bound_ms, bound_by) = timed[C]
        print(f"[kernels] dt_loss ({C},512,{D}), one launch: kernel "
              f"{ms:.4f} ms (device {dev_ms:.4f} ms a launch, "
              f"{dev_ms / C:.4f} ms a client), plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}; {C} x the C = 1 "
              f"bound)", flush=True)
    C = CLIENTS_PER_CHUNK
    ms, dev_ms, plain_ms, (bound_ms, bound_by) = timed[C]
    attrs = dt_kernel.kernel_attributes(D)
    rows.append({"name": "dt_loss", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/dt_loss.cu",
                 "replaces": "src/repro/kernels/dt_loss.py:33",
                 "shape": [C, 512, D],
                 "max_abs_err": max(errs), "ms": ms, "device_ms": dev_ms,
                 "device_ms_per_client": dev_ms / C,
                 "device_ms_1": timed[1][1], "device_ms_5": timed[5][1],
                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "bound_ms_1": timed[1][3][0],
                 "library_ms": None,
                 "regs": attrs["regs"], "local_bytes": attrs["local_bytes"],
                 "blocks_per_sm": attrs["blocks_per_sm"]})
    print(f"[kernels] dt_loss: {attrs['regs']} registers and "
          f"{attrs['local_bytes']} local bytes a thread, "
          f"{attrs['shared_bytes']} shared bytes and {attrs['threads']} "
          f"threads a CTA, {attrs['blocks_per_sm']} CTAs an SM, clusters of "
          f"{attrs['cluster']} CTAs", flush=True)
    return rows


def _unit_rows(g, dev, shape):
    import torch
    return torch.nn.functional.normalize(
        torch.randn(shape, generator=g, device=dev), dim=-1)


def _dt_bound(c: int, m: int, d: int):
    """(ms, what bounds it) for the DT loss of c clients: q and k read
    once, four (c, m) outputs written, and 2 m^2 d operations a client
    three times (both DT kernels form the similarity in 3xTF32 on the
    tensor cores: hi*hi, lo*hi, hi*lo) at the TF32 rate."""
    return _bound(4 * c * (2 * m * d + 4 * m), 3 * 2 * c * m * m * d,
                  TF32_FLOP_PER_S)


def _dt_cohort_checks(dev, g) -> list:
    """The DT kernel's cohort form, one launch for C clients, against
    the cohort plain version at (5, 512, 128) and at (3, 500, 128) and
    (3, 513, 128), where the ragged rows and keys sit at the client
    boundaries; two calls bitwise equal; the gradients through
    torch.func.vmap(torch.func.grad) (one launch) against a loop of the
    unbatched autograd path. Returns the errors."""
    import torch

    from repro_torch.kernels import dt_loss as dt_kernel
    from repro_torch.kernels import ops, ref

    errs = []
    for C, M in ((5, 512), (3, 500), (3, 513)):
        q = _unit_rows(g, dev, (C, M, 128))
        k = _unit_rows(g, dev, (C, M, 128))
        for ta, tb in DT_TAUS:
            before = dt_kernel.LAUNCHES
            got = ops.dt_loss_fwd(q, k, ta, tb)
            launched = dt_kernel.LAUNCHES - before
            want = ref.dt_loss_fwd_cohort_ref(q, k, ta, tb)
            fwd_err = max(_max_err(a, b) for a, b in zip(got, want))
            again = ops.dt_loss_fwd(q, k, ta, tb)
            torch.cuda.synchronize()
            if launched != 1 or not all(torch.equal(a, b)
                                        for a, b in zip(got, again)):
                raise AssertionError(f"dt_loss cohort ({C},{M}): {launched} "
                                     f"launches, or two calls differ")
            if not fwd_err <= DT_FWD_TOL:
                raise AssertionError(f"dt_loss cohort ({C},{M}) taus=({ta}, "
                                     f"{tb}): {fwd_err} > {DT_FWD_TOL}")

            def loss(a, b):
                return ops.dt_loss(a, b, ta, tb)

            before = dt_kernel.LAUNCHES
            gq, gk = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)))(
                q, k)
            launched = dt_kernel.LAUNCHES - before
            grad_err = 0.0
            for c in range(C):
                qc = q[c].clone().requires_grad_()
                kc = k[c].clone().requires_grad_()
                a, b = torch.autograd.grad(loss(qc, kc), (qc, kc))
                grad_err = max(grad_err, _max_err(a, gq[c]),
                               _max_err(b, gk[c]))
            if launched != 1 or not grad_err <= DT_GRAD_TOL:
                raise AssertionError(f"dt_loss cohort ({C},{M}) vmapped "
                                     f"grad: {launched} launches, err "
                                     f"{grad_err} > {DT_GRAD_TOL}")
            errs.append(max(fwd_err, grad_err))
            print(f"[kernels] dt_loss cohort ({C},{M},128) taus=({ta}, "
                  f"{tb}), one launch: fwd err {fwd_err:.3e}, vmapped grad "
                  f"vs the unbatched loop {grad_err:.3e}, two calls bitwise "
                  f"equal", flush=True)
    return errs


def q8_kernels(dev):
    """q8_encode / q8_decode against the plain versions at (5, Ppad) (the
    cohort roundtrip), (3, Ppad) and (2, Ppad) (a download group of the
    handover or an RSU group of MultiRSU) and (1, Ppad) (a snapshot
    publish or fetch); timed at (5, Ppad) and (1, Ppad)."""
    import torch

    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(1)
    times = {}
    for n in (5, 3, 2, 1):
        x = torch.randn((n, Q8_PPAD), generator=g, device=dev) * 1e-2
        e = torch.randn((n, Q8_PPAD), generator=g, device=dev) * 1e-4
        x[:, WAGG_P:] = 0.0      # the codec's zero padding past P
        e[:, WAGG_P:] = 0.0
        x[:, :BQ] = 0.0          # one all-zero block
        e[:, :BQ] = 0.0
        codes, scales, new_ef = ops.q8_encode_flat(x, e)
        out = ops.q8_decode_flat(codes, scales)
        c_r, s_r, e_r = ref.q8_encode_ref(x, e)
        out_r = ref.q8_decode_ref(codes, scales)
        # ragged P (not a multiple of 256): ops pads it with zeros
        c_g, s_g, e_g = ops.q8_encode_flat(x[:, :WAGG_P], e[:, :WAGG_P])
        out_g = ops.q8_decode_flat(c_g, s_g)
        torch.cuda.synchronize()
        if not (torch.equal(codes, c_r) and torch.equal(scales, s_r)
                and torch.equal(new_ef, e_r)):
            raise AssertionError(f"q8_encode ({n}, Ppad): not bitwise equal "
                                 f"to the plain version")
        if not torch.equal(out, out_r):
            raise AssertionError(f"q8_decode ({n}, Ppad): not bitwise equal "
                                 f"to the plain version")
        if not (torch.equal(c_g, codes[:, :WAGG_P])
                and torch.equal(s_g, scales)
                and torch.equal(e_g, new_ef[:, :WAGG_P])
                and torch.equal(out_g, out[:, :WAGG_P])):
            raise AssertionError(f"q8 ({n}, {WAGG_P}): ragged call is not "
                                 f"bitwise equal to the aligned call")
        if scales[:, 0].any() or codes[:, :BQ].any() or out[:, :BQ].any():
            raise AssertionError("q8: the all-zero block does not decode "
                                 "to zeros")
        del c_r, s_r, e_r, out_r, c_g, s_g, e_g, out_g
        if n not in (5, 1):
            print(f"[kernels] q8 ({n}, {Q8_PPAD}): codes, scales, new_ef "
                  f"and decode bitwise equal to the plain versions, ragged "
                  f"P={WAGG_P} == aligned, zero block exact", flush=True)
            del x, e, codes, scales, new_ef, out
            continue
        times[n] = (
            _time_ms(lambda: ops.q8_encode_flat(x, e)),
            _time_ms(lambda: ref.q8_encode_ref(x, e)),
            _time_ms(lambda: ops.q8_decode_flat(codes, scales)),
            _time_ms(lambda: ref.q8_decode_ref(codes, scales)),
            _time_ms(lambda: torch.mul(codes.view(n, -1, BQ),
                                       scales[..., None])),
            _device_ms(lambda: ops.q8_encode_flat(x, e), "q8_encode_kernel"),
            _device_ms(lambda: ops.q8_decode_flat(codes, scales),
                       "q8_decode_kernel"))
        print(f"[kernels] q8 ({n}, {Q8_PPAD}): codes, scales, new_ef and "
              f"decode bitwise equal to the plain versions, ragged "
              f"P={WAGG_P} == aligned, zero block exact; encode "
              f"{times[n][0]:.4f} ms (device {times[n][5]:.4f}, plain "
              f"{times[n][1]:.4f}), decode {times[n][2]:.4f} ms (device "
              f"{times[n][6]:.4f}, plain {times[n][3]:.4f}, torch.mul "
              f"{times[n][4]:.4f})", flush=True)
        del x, e, codes, scales, new_ef, out
    n, elems = 5, 5 * Q8_PPAD
    blocks = elems // BQ
    enc_bound = _bound(elems * (4 + 4 + 1 + 4) + blocks * 4,
                       elems * 5 + blocks * 2)
    dec_bound = _bound(elems * (1 + 4) + blocks * 4, elems)
    common = {"route": "cuda", "source": "src/repro_torch/kernels/csrc/"
              "qdelta.cu", "max_abs_err": 0.0}
    enc_ms, enc_plain, dec_ms, dec_plain, dec_lib, enc_dev, dec_dev = \
        times[n]
    # device_ms_1: the device time at (1, Ppad), a publish or a fetch
    return [dict(common, name="q8_encode",
                 replaces="src/repro/kernels/qdelta.py:32", ms=enc_ms,
                 device_ms=enc_dev, device_ms_1=times[1][5],
                 plain_ms=enc_plain, bound_ms=enc_bound[0],
                 bound_by=enc_bound[1], library_ms=None),
            dict(common, name="q8_decode",
                 replaces="src/repro/kernels/qdelta.py:46", ms=dec_ms,
                 device_ms=dec_dev, device_ms_1=times[1][6],
                 plain_ms=dec_plain, bound_ms=dec_bound[0],
                 bound_by=dec_bound[1], library_ms=dec_lib)]


def cross_check(dev):
    """One small round on the card and on the CPU, same plan."""
    import numpy as np
    import torch

    from repro_torch.convert import ravel
    from repro_torch.core.scenario import Scenario, run_round

    rs = np.random.RandomState(0)
    data = [rs.rand(24, 16, 16, 3).astype(np.float32) for _ in range(4)]
    kw = dict(n_vehicles=4, vehicles_per_round=2, batch_size=8, data=data,
              rounds=4)
    out = []
    for d in (dev, "cpu"):
        sc = Scenario(device=d, **kw)
        state = sc.init_state()
        start = ravel(state.global_tree).cpu()
        st, rec = run_round(state, sc)
        out.append((ravel(st.global_tree).cpu(), rec))
    (t_gpu, r_gpu), (t_cpu, r_cpu) = out
    max_abs = float((t_gpu - t_cpu).abs().max())
    rel = float((t_gpu - t_cpu).norm() / (t_cpu - start).norm())
    dloss = abs(r_gpu["loss"] - r_cpu["loss"])
    print(f"[cross] card vs cpu: loss {r_gpu['loss']:.7f} vs "
          f"{r_cpu['loss']:.7f}, tree max abs diff {max_abs:.3e}, relative "
          f"to the update {rel:.3e}", flush=True)
    if r_gpu["velocities"] != r_cpu["velocities"]:
        raise AssertionError("cross-check: velocities differ")
    if not bool(torch.isfinite(t_gpu).all()):
        raise AssertionError("cross-check: card tree not finite")
    if not (dloss <= CROSS_LOSS_TOL and max_abs <= CROSS_MAX_ABS
            and rel <= CROSS_REL_UPDATE):
        raise AssertionError(f"cross-check: loss diff {dloss}, tree max "
                             f"abs {max_abs}, relative {rel}")


def _state_to(state, dev):
    """`state` with every tensor (trees, RSU models, FedCo state, comms)
    on `dev`; the host fields are shared."""
    from repro_torch.convert import tree_map

    def mv(x):
        return None if x is None else tree_map(lambda t: t.to(dev), x)

    topo = dict(state.topo)
    if "rsu_models" in topo:
        topo["rsu_models"] = tuple(mv(t) for t in topo["rsu_models"])
    return state.replace(global_tree=mv(state.global_tree), topo=topo,
                         client_state=mv(state.client_state),
                         comms=mv(state.comms))


def _state_rows(state) -> list:
    """The CPU flat rows of the global tree, each RSU model and FedCo's
    key tree and queue."""
    from repro_torch.convert import ravel
    trees = (state.global_tree,) + tuple(state.topo.get("rsu_models", ()))
    rows = [ravel(t).cpu() for t in trees]
    if state.client_state is not None:
        rows += [ravel(state.client_state["key_tree"]).cpu(),
                 state.client_state["queue"].reshape(-1).cpu()]
    return rows


def _recording_scales(scales: list):
    """Wrap the delta_int8 codec's encode so that each call appends its
    largest block scale to `scales`; returns the function that restores
    the codec."""
    import dataclasses

    from repro_torch.comms import codecs

    codec = codecs.CODECS["delta_int8"]

    def encode(rows, base, ef=None):
        payload, new_ef = codec.encode(rows, base, ef)
        scales.append(float(payload["scales"].max()))
        return payload, new_ef

    codecs.CODECS["delta_int8"] = dataclasses.replace(codec, encode=encode)
    return lambda: codecs.CODECS.__setitem__("delta_int8", codec)


def topo_cross_check(dev):
    """[topo]: small rounds of MultiRSU, the handover (two rounds: a
    handover and the sync) and FedCo, each from one state on the card and
    on the CPU, held at the cross-check tolerances (global tree and every
    RSU model, relative to its own update); MultiRSU and the handover
    again with codec="delta_int8", error feedback included."""
    scales = []
    restore = _recording_scales(scales)
    try:
        _topo_cross_check(dev, scales)
    finally:
        restore()


def _topo_cross_check(dev, scales):
    import numpy as np
    import torch

    from repro_torch.core.scenario import Scenario, run_round

    rs = np.random.RandomState(0)
    data = [rs.rand(24, 16, 16, 3).astype(np.float32) for _ in range(6)]
    kw = dict(n_vehicles=6, vehicles_per_round=3, batch_size=8, data=data,
              rounds=4)
    multi = dict(topology="multi", topology_kwargs={"n_rsus": 2})
    handover = dict(topology="handover", topology_kwargs=dict(
        n_rsus=2, rsu_range=100.0, sync_every=2))
    cases = (("multi", multi, 1), ("handover", handover, 2),
             ("fedco", dict(aggregator="fedco", queue_len=256), 1),
             ("multi delta_int8", dict(multi, codec="delta_int8"), 1),
             ("handover delta_int8", dict(handover, codec="delta_int8"), 2))
    for name, extra, rounds in cases:
        scs = {d: Scenario(device=d, **kw, **extra) for d in (dev, "cpu")}
        state = scs["cpu"].init_state()
        handovers, synced = 0, False
        for _ in range(rounds):
            out = {}
            del scales[:]
            for d, sc in scs.items():
                torch.cuda.synchronize()
                _zero_counts()
                out[d] = run_round(_state_to(state, d), sc)
                torch.cuda.synchronize()
                if d == dev:
                    launches, encodes = _counts(), len(scales)
            # one code step of the largest scale either side encoded with
            step = max(scales, default=0.0)
            (st_g, r_g), (st_c, r_c) = out[dev], out["cpu"]
            if not all(bool(torch.isfinite(a).all())
                       for a in _state_rows(st_g)):
                raise AssertionError(f"[topo] {name}: card tree not finite")
            worst = _rows_diff(st_g, st_c, state)
            dloss = abs(r_g["loss"] - r_c["loss"])
            same = {k: r_g[k] == r_c[k] for k in ("velocities", "rsu_sizes",
                                                  "n_handovers", "synced")
                    if k in r_c}
            ef_err = 0.0
            if st_c.comms is not None:
                ef_g, ef_c = st_g.comms["ef"].cpu(), st_c.comms["ef"]
                if ef_g.shape != ef_c.shape \
                        or not bool(torch.isfinite(ef_g).all()):
                    raise AssertionError(f"[topo] {name}: card EF of shape "
                                         f"{tuple(ef_g.shape)} or not finite")
                ef_err = float((ef_g - ef_c).abs().max())
            q8 = (launches["q8_encode"], launches["q8_decode"])
            print(f"[topo] {name} round {r_c['round']}: loss "
                  f"{r_g['loss']:.7f} (card) vs {r_c['loss']:.7f} (cpu); "
                  f"trees max abs {worst[0]:.3e}, relative to the update "
                  f"{worst[1]:.3e}; EF max abs {ef_err:.3e}; code step "
                  f"{step:.3e}; card q8 launches {q8} for {encodes} "
                  f"encodes; records equal {same}", flush=True)
            if not (all(same.values()) and dloss <= CROSS_LOSS_TOL
                    and worst[0] <= CROSS_MAX_ABS + step
                    and ef_err <= CROSS_MAX_ABS + step
                    and worst[1] <= CROSS_REL_UPDATE):
                raise AssertionError(f"[topo] {name}: loss diff {dloss}, "
                                     f"trees {worst}, EF {ef_err}, step "
                                     f"{step}, records {same}")
            if q8 != (encodes, encodes) or (extra.get("codec")
                                            and not encodes):
                raise AssertionError(f"[topo] {name}: card q8 launches {q8} "
                                     f"for {encodes} encodes")
            handovers += r_c.get("n_handovers", 0)
            synced = synced or r_c.get("synced", False)
            state = st_c
        if name == "handover" and not (handovers and synced):
            raise AssertionError(f"[topo] handover: {handovers} handovers, "
                                 f"synced {synced}")


def _plan_of(sc, state):
    """The plan of `state`'s next round under `sc` (pure: fresh copies of
    both random streams)."""
    from repro_torch.core import topology as T
    from repro_torch.core.state import generator_from, unpack_host_rng

    rng, gen = unpack_host_rng(state.host_rng), generator_from(state.gen_state)
    if sc.topology.name != "handover":
        return T._cohort_plan(rng, gen, state.round, sc)
    positions = state.topo["positions"]
    return sc.topology.plan_round(
        sc.topology.draw_round(rng, gen, positions, sc), state.round,
        positions, state.topo["blur_sum"], state.topo["upload_count"], sc)


def _round_launches(sc, plan, parallel: bool = True) -> dict:
    """The kernel launches one round of `sc` makes, from its plan. The
    training groups are the cohort (SingleRSU), the round-robin RSU
    groups (MultiRSU) or the download groups (the handover, each padded
    to its bucket_size under parallel and bucketed). dt_loss: one launch
    per chunk of CLIENTS_PER_CHUNK clients per local iteration in each
    group under parallel=True, one per client per iteration under
    parallel=False, none for FedCo. wagg: one per group and one for the
    region (MultiRSU), one per upload group and one for a sync (the
    handover), one (SingleRSU). q8_encode and q8_decode: one each per
    group under delta_int8 (the padded rows are not encoded)."""
    from repro_torch.core.clients import CLIENTS_PER_CHUNK

    cfg, topo = sc.cfg, sc.topology
    n = len(plan.ids)
    if topo.name == "handover":
        groups = [int(s.size) for _, s in plan.down_groups]
        trained = [topo.pad_to(g) or g for g in groups] if parallel \
            else groups
        wagg = len(plan.uploads) + int(plan.synced)
    elif topo.name == "multi":
        groups = trained = [len(range(r, n, topo.n_rsus))
                            for r in range(min(topo.n_rsus, n))]
        wagg = len(groups) + 1
    else:
        groups = trained = [n]
        wagg = 1
    per = sum(-(-g // CLIENTS_PER_CHUNK) if parallel else g for g in trained)
    q8 = len(groups) if cfg.codec == "delta_int8" else 0
    return {"wagg": wagg,
            "dt_loss": 0 if cfg.client == "fedco" else cfg.local_iters * per,
            "q8_encode": q8, "q8_decode": q8, "rwkv6": 0,
            "dt_loss_wide": 0}


def _add(total: dict, more: dict) -> dict:
    return {k: total.get(k, 0) + more.get(k, 0) for k in {*total, *more}}


def _zero_counts() -> None:
    from repro_torch.kernels import dt_loss, qdelta, rwkv6, wagg
    wagg.LAUNCHES = dt_loss.LAUNCHES = rwkv6.LAUNCHES = 0
    dt_loss.WIDE_LAUNCHES = 0
    qdelta.ENCODE_LAUNCHES = qdelta.DECODE_LAUNCHES = 0


def _counts() -> dict:
    from repro_torch.kernels import ops
    return ops.launch_counts()


def main_path(dev):
    """3 Table-1 rounds with the batched cohort step (parallel=True, the
    default), then 3 more from round 0 with parallel=False for their
    times; returns (launches per kernel of the batched rounds, the
    scenario, the final state)."""
    import math

    import torch

    from repro_torch.convert import ravel
    from repro_torch.core.aggregation import flsimco_weights
    from repro_torch.core.scenario import Scenario, run_round
    from repro_torch.trace_round import TABLE1

    t0 = time.time()
    sc = Scenario(device=dev, **TABLE1)
    state = sc.init_state()
    print(f"[main] data {len(sc.dataset[0])} images over "
          f"{len(sc.data)} vehicles, set-up {time.time() - t0:.2f} s",
          flush=True)
    start = state
    before = ravel(state.global_tree).clone()
    rounds = 3
    runs = {}
    for parallel in (True, False):
        state, want, times = start, {}, []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        for _ in range(rounds):
            want = _add(want, _round_launches(sc, _plan_of(sc, state),
                                              parallel))
            t = time.time()
            state, rec = run_round(state, sc, parallel=parallel)
            torch.cuda.synchronize()
            times.append(time.time() - t)
            w = flsimco_weights(sc.mobility.blur_level(rec["velocities"]))
            print(f"[main] round {rec['round']} (parallel={parallel}): "
                  f"{times[-1]:.3f} s, loss {rec['loss']:.6f}, lr "
                  f"{rec['lr']:.6f}, weights "
                  f"{[round(float(x), 4) for x in w]}", flush=True)
            if not math.isfinite(rec["loss"]):
                raise AssertionError(f"round {rec['round']}: loss not "
                                     f"finite")
            if abs(float(w.sum()) - 1.0) > 1e-6:
                raise AssertionError(f"Eq.-11 weights sum to "
                                     f"{float(w.sum())}")
        launches = _counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"[main] parallel={parallel}: launches {launches} (expected "
              f"{want}: dt_loss a round = local_iters x "
              f"{'ceil(5 / CLIENTS_PER_CHUNK)' if parallel else '5'}); "
              f"peak memory {peak:.2f} GiB", flush=True)
        if launches != want:
            raise AssertionError(f"kernel launches {launches} != {want}")
        after = ravel(state.global_tree)
        if after.shape != before.shape \
                or not bool(torch.isfinite(after).all()):
            raise AssertionError("global tree has the wrong shape or is "
                                 "not finite")
        if torch.equal(after, before):
            raise AssertionError("global tree did not change")
        runs[parallel] = (launches, state, times, peak)
    print(f"[main] round times, batched (parallel=True) "
          f"{[round(t, 4) for t in runs[True][2]]} s, peak "
          f"{runs[True][3]:.2f} GiB; client by client (parallel=False) "
          f"{[round(t, 4) for t in runs[False][2]]} s, peak "
          f"{runs[False][3]:.2f} GiB", flush=True)
    launches, state = runs[True][:2]
    return launches, sc, state


def comms_path(dev, main_sc, main_state):
    """3 Table-1 rounds with codec="delta_int8" through `run`, published
    into a delta_int8 store. Returns (launches, scenario, state, store)."""
    import math

    import torch

    from repro_torch.comms.codecs import flat_width
    from repro_torch.convert import ravel
    from repro_torch.core.scenario import Scenario, run
    from repro_torch.serve import ModelStore
    from repro_torch.trace_round import TABLE1

    sc = Scenario(device=dev, codec="delta_int8", data=main_sc.data,
                  **TABLE1)
    state = sc.init_state()
    store = ModelStore(codec="delta_int8")
    store.publish(state.round, state.global_tree)
    rounds, want = 3, {}
    torch.cuda.synchronize()
    _zero_counts()
    for _ in range(rounds):
        # the round's launches, and one q8 pair for its publish
        want = _add(want, _round_launches(sc, _plan_of(sc, state)))
        want = _add(want, {"q8_encode": 1, "q8_decode": 1})
        t = time.time()
        state, (rec,) = run(sc, state, rounds=1, publish=store.publish)
        torch.cuda.synchronize()
        print(f"[comms] round {rec['round']} (delta_int8, published): "
              f"{time.time() - t:.3f} s, loss {rec['loss']:.6f}", flush=True)
        if not math.isfinite(rec["loss"]):
            raise AssertionError(f"comms round {rec['round']}: loss not "
                                 f"finite")
    launches = _counts()
    print(f"[comms] launches {launches} (expected {want}: a round wagg 1, "
          f"dt_loss ceil(5 / CLIENTS_PER_CHUNK), q8 pairs 2)", flush=True)
    if launches != want:
        raise AssertionError(f"comms launches {launches} != {want}")
    ef = state.comms["ef"]
    tree = ravel(state.global_tree)
    if tuple(ef.shape) != (sc.cfg.vehicles_per_round,
                           flat_width(state.global_tree)) \
            or not bool(torch.isfinite(ef).all()) \
            or not bool(torch.isfinite(tree).all()):
        raise AssertionError("comms: EF or tree of the wrong shape or not "
                             "finite")
    if store.rounds() != list(range(rounds + 1)):
        raise AssertionError(f"comms: store holds rounds {store.rounds()}")
    ident = ravel(main_state.global_tree)
    start = ravel(sc.init_state().global_tree)
    print(f"[comms] after {rounds} rounds, delta_int8 vs identity tree: max "
          f"abs diff {float((tree - ident).abs().max()):.3e}, "
          f"{float((tree - ident).norm() / (ident - start).norm()):.3e} of "
          f"the identity run's update; EF max abs "
          f"{float(ef.abs().max()):.3e}; snapshot payload "
          f"{store.get(rounds).delta_nbytes} bytes", flush=True)
    return launches, sc, state, store


def _check_round(tag: str, rec, state) -> None:
    import math

    import torch

    from repro_torch.convert import ravel
    if not math.isfinite(rec["loss"]):
        raise AssertionError(f"[{tag}] round {rec['round']}: loss not finite")
    for t in (state.global_tree,) + tuple(state.topo.get("rsu_models", ())):
        if not bool(torch.isfinite(ravel(t)).all()):
            raise AssertionError(f"[{tag}] round {rec['round']}: a model is "
                                 f"not finite")


def multi_path(dev, data):
    """[multi]: 2 Table-1 rounds of MultiRSU(n_rsus=2); returns the
    launches."""
    import torch

    from repro_torch.core.scenario import Scenario, run_round
    from repro_torch.trace_round import TABLE1

    sc = Scenario(device=dev, data=data, **dict(
        TABLE1, topology="multi", topology_kwargs={"n_rsus": 2}))
    state = sc.init_state()
    rounds, want = 2, {}
    torch.cuda.synchronize()
    _zero_counts()
    for _ in range(rounds):
        want = _add(want, _round_launches(sc, _plan_of(sc, state)))
        t = time.time()
        state, rec = run_round(state, sc)
        torch.cuda.synchronize()
        print(f"[multi] round {rec['round']}: {time.time() - t:.3f} s, loss "
              f"{rec['loss']:.6f}, rsu_sizes {rec['rsu_sizes']}", flush=True)
        _check_round("multi", rec, state)
        if rec["rsu_sizes"] != [3, 2]:
            raise AssertionError(f"[multi] rsu_sizes {rec['rsu_sizes']}")
    launches = _counts()
    print(f"[multi] launches {launches} (expected {want}: a round wagg "
          f"2 groups + 1 region, dt_loss one chunk a group)", flush=True)
    if launches != want:
        raise AssertionError(f"[multi] launches {launches} != {want}")
    return launches


def mesh_path(dev, data):
    """[mesh]: the sharded cohort forms over NCCL at world size 1, at full
    width (P = 11,506,624, a 5-row cohort): gather, split and exact
    bitwise their host forms, psum within WAGG_TOL, the five schemes of
    `sharded_aggregate`; then MultiRSU(n_rsus=1, mesh_aggregate=True) at
    the Table-1 setting, 2 rounds through `run` (launches counted) and 2
    through `run_campaign`, each round's global row against the
    mesh_aggregate=False round from the same state; MultiRSU(n_rsus=2,
    mesh_aggregate=True) raises before any training. Returns the
    launches of the `run` rounds."""
    import torch
    import torch.distributed as dist

    from repro_torch.convert import flat_spec, ravel
    from repro_torch.core import aggregation as agg
    from repro_torch.core import collectives as C
    from repro_torch.core import engine
    from repro_torch.core import hierarchical as H
    from repro_torch.core.cohort import CohortBatch
    from repro_torch.core.scenario import Scenario, run, run_campaign
    from repro_torch.core.state import FLConfig
    from repro_torch.launch import mesh as M
    from repro_torch.trace_round import TABLE1

    mesh = M.cohort_mesh(1, 1, dev)
    print(f"[mesh] {dist.get_backend()} group of {dist.get_world_size()} "
          f"rank(s), mesh {tuple(mesh.shape)} {mesh.mesh_dim_names}: one "
          f"card, one rank; no speed is claimed for the sharding",
          flush=True)
    # the one group serves CPU tensors too (gloo beside NCCL), so a CPU
    # scenario after a card one (or before it) finds its backend
    cx = torch.arange(12.0).view(3, 4)
    cc = CohortBatch(flat=cx, spec=flat_spec({"w": cx[0]}),
                     losses=torch.zeros(3), mask=torch.ones(3), n=3)
    cw = torch.full((3,), 0.25)
    cpu_mesh = M.cohort_mesh(1, 1, "cpu")
    if not torch.equal(H.sharded_cohort_row(cc, cw, cpu_mesh),
                       agg.cohort_weighted_row(cc, cw)):
        raise AssertionError("[mesh] the CPU mesh on the same group differs "
                             "from the host sum")
    g = torch.Generator(device=dev).manual_seed(3)
    m = 5
    x = torch.randn((m, WAGG_P), generator=g, device=dev)
    # the reference's discard case: blur straddling blur_threshold
    blur = torch.tensor([11.6, 17.4, 12.8, 19.0, 14.2], device=dev)
    spec = flat_spec({"w": x[0]})
    cohort = CohortBatch(flat=x, spec=spec, losses=torch.zeros(m, device=dev),
                         mask=torch.ones(m, device=dev), n=m).with_stats(
                             blur=blur)
    w = agg.flsimco_weights(blur)
    host = agg.cohort_weighted_row(cohort, w)
    host_h = H.hierarchical_row([cohort])
    forms = {
        "gather": lambda: H.sharded_cohort_row(cohort, w, mesh),
        "split": lambda: H.sharded_cohort_row(cohort, w, mesh,
                                              reduction="split"),
        "exact": lambda: H.sharded_hierarchical_row(cohort, mesh, 1),
        "psum": lambda: H.sharded_hierarchical_row(cohort, mesh, 1,
                                                   reduction="psum")}
    got = {k: f() for k, f in forms.items()}
    torch.cuda.synchronize()
    for k in ("gather", "split"):
        if not torch.equal(got[k], host):
            raise AssertionError(f"[mesh] {k} is not bitwise the host sum")
    if not torch.equal(got["exact"], host_h):
        raise AssertionError("[mesh] exact is not bitwise the host hierarchy")
    psum_err = _max_err(got["psum"], host_h)
    if not psum_err <= WAGG_TOL:
        raise AssertionError(f"[mesh] psum max abs err {psum_err} > "
                             f"{WAGG_TOL}")
    for name in sorted(agg.AGGREGATORS):
        cfg = FLConfig(aggregator=name)
        want = ravel(agg.AGGREGATORS[name](cohort, cfg))
        for red in ("gather", "split"):
            if not torch.equal(ravel(H.sharded_aggregate(
                    cohort, cfg, mesh, reduction=red)), want):
                raise AssertionError(f"[mesh] sharded_aggregate {name} "
                                     f"{red} is not bitwise the host's")
    ms = {k: _time_ms(f, iters=10) for k, f in forms.items()}
    ms["host"] = _time_ms(lambda: agg.cohort_weighted_row(cohort, w),
                          iters=10)
    row = host.clone()
    cols = torch.empty_like(x)
    coll = {"all_gather (5, P)": lambda: C.all_gather_rows(x),
            "all_reduce (P,)": lambda: dist.all_reduce(row),
            "all_to_all (5, P)": lambda: dist.all_to_all_single(cols, x)}
    coll_ms = {k: _time_ms(f, iters=10) for k, f in coll.items()}
    print(f"[mesh] P={WAGG_P}, m={m}: gather, split, exact bitwise the "
          f"host forms, psum max abs err {psum_err:.3e} (limit "
          f"{WAGG_TOL}), the five schemes bitwise in both reductions; ms "
          f"{ {k: round(v, 4) for k, v in ms.items()} }; collectives at "
          f"world size 1, ms { {k: round(v, 4) for k, v in coll_ms.items()} }",
          flush=True)
    del x, cols, row, cohort, got
    # MultiRSU at the Table-1 setting, one RSU a pod of one rank
    kw = dict(TABLE1, topology="multi")
    on = Scenario(device=dev, data=data, **dict(
        kw, topology_kwargs={"n_rsus": 1, "mesh_aggregate": True}))
    off = Scenario(device=dev, data=data, **dict(
        kw, topology_kwargs={"n_rsus": 1, "mesh_aggregate": False}))
    states, want, hist = [on.init_state()], {}, []
    torch.cuda.synchronize()
    _zero_counts()
    for _ in range(2):
        want = _add(want, _round_launches(on, _plan_of(on, states[-1])))
        t = time.time()
        st, (rec,) = run(on, states[-1], rounds=1)
        torch.cuda.synchronize()
        print(f"[mesh] MultiRSU(1, mesh_aggregate=True) round "
              f"{rec['round']}: {time.time() - t:.3f} s, loss "
              f"{rec['loss']:.6f}", flush=True)
        _check_round("mesh", rec, st)
        states.append(st)
        hist.append(rec)
    launches = _counts()
    print(f"[mesh] launches {launches} (expected {want}: a round wagg 1 "
          f"RSU + 1 region, dt_loss ceil(5 / CLIENTS_PER_CHUNK))",
          flush=True)
    if launches != want:
        raise AssertionError(f"[mesh] launches {launches} != {want}")
    trees = []
    camp, camp_hist = run_campaign(
        on, states[0], rounds=2, publish_every=1,
        publish=lambda r, tree: trees.append(ravel(tree).clone()))
    torch.cuda.synchronize()
    mode = engine.resolve_mode("auto", dev,
                               engine._campaign_mesh(on) is not None)
    engine.reset_engine_caches()
    if mode != "graph" or len(trees) != 2:
        raise AssertionError(f"[mesh] campaign at one rank: mode {mode}, "
                             f"{len(trees)} publishes")
    if _sans_loss(camp_hist) != _sans_loss(hist):
        raise AssertionError("[mesh] campaign schedule differs from run's")
    for k in range(2):
        # the host round from the state each mesh round started from
        start = states[k]
        host_st, (host_rec,) = run(off, start, rounds=1)
        # the campaign's round k began from its own tree after round k - 1
        # and the same random streams (its schedule is run's, bitwise)
        camp_start = start if k == 0 else start.replace(
            global_tree=_tree_of(trees[k - 1], start))
        camp_st = start.replace(global_tree=_tree_of(trees[k], start))
        host_c, _ = run(off, camp_start, rounds=1)
        for tag, a, b, s0 in (("run", states[k + 1], host_st, start),
                              ("campaign", camp_st, host_c, camp_start)):
            d, rel = _rows_diff(a, b, s0)
            print(f"[mesh] round {k} {tag} against mesh_aggregate=False "
                  f"from the same state: max abs {d:.3e}, {rel:.3e} of "
                  f"the update", flush=True)
            if not (d <= CROSS_MAX_ABS and rel <= CROSS_REL_UPDATE):
                raise AssertionError(f"[mesh] round {k} {tag}: {d} max "
                                     f"abs, {rel} of the update")
        if abs(host_rec["loss"] - hist[k]["loss"]) > CROSS_LOSS_TOL:
            raise AssertionError(f"[mesh] round {k} loss "
                                 f"{hist[k]['loss']} vs {host_rec['loss']}")
    print(f"[mesh] run_campaign ({mode} mode at one rank) 2 rounds: "
          f"schedule bitwise run's", flush=True)
    # 2 RSUs need 2 ranks (and 5 vehicles do not split over 2): raised
    # while the scenario is built, before any training
    _zero_counts()
    for vehicles, words in ((5, "not divisible"), (4, "needs 2 ranks")):
        try:
            Scenario(device=dev, data=data, **dict(
                kw, vehicles_per_round=vehicles,
                topology_kwargs={"n_rsus": 2, "mesh_aggregate": True}))
        except ValueError as e:
            if words not in str(e):
                raise
            print(f"[mesh] MultiRSU(2, mesh_aggregate=True), {vehicles} "
                  f"vehicles a round: ValueError: {e}", flush=True)
        else:
            raise AssertionError("[mesh] MultiRSU(2, mesh_aggregate=True) "
                                 "did not raise on one rank")
    if any(_counts().values()):
        raise AssertionError(f"[mesh] the refused scenarios launched "
                             f"{_counts()}")
    H.reset_sharded_caches()
    dist.destroy_process_group()
    return launches


def _tree_of(row, state):
    from repro_torch.convert import flat_spec, unravel
    return unravel(row, flat_spec(state.global_tree))


def handover_path(dev, data):
    """[handover]: 5 Table-1 rounds of HandoverMultiRSU at the reference's
    defaults with codec="delta_int8", then one region_view; returns the
    launches."""
    import torch

    from repro_torch.core.scenario import Scenario, run_round
    from repro_torch.trace_round import TABLE1

    sc = Scenario(device=dev, data=data, **dict(
        TABLE1, topology="handover", topology_kwargs={},
        codec="delta_int8"))
    topo = sc.topology
    state = sc.init_state()
    rounds, want = 5, {"wagg": 1}                   # + the region_view
    handovers, syncs = 0, []
    torch.cuda.synchronize()
    _zero_counts()
    for _ in range(rounds):
        # the round's plan once more, for the expected launch counts
        plan = _plan_of(sc, state)
        want = _add(want, _round_launches(sc, plan))
        t = time.time()
        state, rec = run_round(state, sc)
        torch.cuda.synchronize()
        dt = time.time() - t
        handovers += rec["n_handovers"]
        if rec["synced"]:
            syncs.append(rec["round"])
        print(f"[handover] round {rec['round']} (delta_int8): {dt:.3f} s, "
              f"loss {rec['loss']:.6f}, download groups "
              f"{[int(s.size) for _, s in plan.down_groups]} (trained as "
              f"{[topo.pad_to(s.size) for _, s in plan.down_groups]}), "
              f"rsu_sizes "
              f"{rec['rsu_sizes']}, n_handovers {rec['n_handovers']}, "
              f"synced {rec['synced']}", flush=True)
        _check_round("handover", rec, state)
    t = time.time()
    view = topo.region_view(state)
    torch.cuda.synchronize()
    launches = _counts()
    print(f"[handover] region_view {1e3 * (time.time() - t):.3f} ms; "
          f"{handovers} handovers, syncs at rounds {syncs}; launches "
          f"{launches} (expected {want})", flush=True)
    if launches != want:
        raise AssertionError(f"[handover] launches {launches} != {want}")
    if not handovers or syncs != [4]:
        raise AssertionError(f"[handover] {handovers} handovers, syncs at "
                             f"{syncs}; expected handovers and the sync at "
                             f"round 4")
    from repro_torch.convert import ravel
    if not bool(torch.isfinite(ravel(view)).all()):
        raise AssertionError("[handover] region_view not finite")
    return launches


def fedco_path(dev, data):
    """[fedco]: 2 Table-1 rounds of the FedCo baseline (the legacy
    aggregator="fedco": FedCo clients, FedAvg) under SingleRSU. Each
    round's merged queue starts with the uploads, held against the
    k-vectors recomputed from the round's plan, and continues with the
    old queue bitwise; the key tree is bitwise the global tree. Returns
    the launches."""
    import torch

    from repro_torch.convert import ravel
    from repro_torch.core import ssl
    from repro_torch.core import topology as T
    from repro_torch.core.scenario import Scenario, run_round
    from repro_torch.core.state import generator_from, unpack_host_rng
    from repro_torch.models.resnet import resnet_apply
    from repro_torch.trace_round import TABLE1

    sc = Scenario(device=dev, data=data, **dict(TABLE1, aggregator="fedco",
                                                client=None))
    state = sc.init_state()
    cfg = sc.cfg
    n_up = cfg.vehicles_per_round * cfg.batch_size
    rounds, checks = 2, []
    torch.cuda.synchronize()
    _zero_counts()
    for _ in range(rounds):
        t = time.time()
        new, rec = run_round(state, sc)
        torch.cuda.synchronize()
        dt = time.time() - t
        _check_round("fedco", rec, new)
        checks.append((state, new))
        print(f"[fedco] round {rec['round']}: {dt:.3f} s, loss "
              f"{rec['loss']:.6f}", flush=True)
        state = new
    launches = _counts()
    want = {"wagg": rounds, "dt_loss": 0, "q8_encode": 0, "q8_decode": 0,
            "rwkv6": 0, "dt_loss_wide": 0}
    print(f"[fedco] launches {launches} (expected {want})", flush=True)
    if launches != want:
        raise AssertionError(f"[fedco] launches {launches} != {want}")
    for old, new in checks:
        queue, prev = new.client_state["queue"], old.client_state["queue"]
        plan = T._cohort_plan(unpack_host_rng(old.host_rng),
                              generator_from(old.gen_state), old.round, sc)
        err = 0.0
        with torch.no_grad():
            for i, (c, idx, v) in enumerate(zip(plan.ids, plan.batch_idx,
                                                plan.velocities)):
                images = T._client_images(sc, c, idx, v, dev)
                d2 = ssl.draws_to(plan.draws[i][-1][1], dev)
                kv, _, _ = resnet_apply(old.client_state["key_tree"],
                                        ssl.pi2(images, d2), train=False)
                rows = queue[i * cfg.batch_size:(i + 1) * cfg.batch_size]
                err = max(err, _max_err(rows, kv))
        tail = torch.equal(queue[n_up:], prev[:cfg.queue_len - n_up])
        key = torch.equal(ravel(new.client_state["key_tree"]),
                          ravel(new.global_tree))
        print(f"[fedco] round {old.round}: queue rows [0, {n_up}) vs the "
              f"recomputed uploads max abs {err:.3e}, rest bitwise the old "
              f"queue {tail}; key_tree bitwise the global tree {key}",
              flush=True)
        if not (err <= FEDCO_KVEC_TOL and tail and key):
            raise AssertionError(f"[fedco] queue err {err}, tail {tail}, "
                                 f"key_tree {key}")
    return launches


def _rows_diff(a_state, b_state, start) -> tuple:
    """(max abs, worst norm relative to the update) of the global tree and
    every RSU model of two states, each against `start`'s."""
    worst = (0.0, 0.0)
    for a, b, s0 in zip(_state_rows(a_state), _state_rows(b_state),
                        _state_rows(start)):
        upd = float((b - s0).norm())
        diff = float((a - b).norm())
        rel = diff / upd if upd else (0.0 if diff == 0 else float("inf"))
        worst = (max(worst[0], float((a - b).abs().max())),
                 max(worst[1], rel))
    return worst


def _padded_state(sc):
    """A round-0 state of `sc` carried through the plans (positions, sync
    statistics, both random streams) until its next round pads a download
    group; the models stay the round-0 ones."""
    from repro_torch.core.cohort import bucket_size
    from repro_torch.core.state import generator_from, unpack_host_rng
    from repro_torch.core.state import pack_host_rng

    state, topo = sc.init_state(), sc.topology
    for _ in range(20):
        rng = unpack_host_rng(state.host_rng)
        gen = generator_from(state.gen_state)
        positions = state.topo["positions"]
        plan = topo.plan_round(topo.draw_round(rng, gen, positions, sc),
                               state.round, positions,
                               state.topo["blur_sum"],
                               state.topo["upload_count"], sc)
        if any(bucket_size(s.size) != s.size for _, s in plan.down_groups):
            return state
        state = state.replace(
            host_rng=pack_host_rng(rng), gen_state=gen.get_state(),
            round=state.round + 1,
            topo=dict(state.topo, positions=plan.positions,
                      blur_sum=plan.blur_sum,
                      upload_count=plan.upload_count))
    raise AssertionError("[batched] no padded download group in 20 plans")


def _chunk_record(sc, state, plan) -> None:
    """The record behind the chunk rule: the peak memory of the batched
    step on this Table-1 cohort with one client more a chunk than
    CLIENTS_PER_CHUNK (printed, not held: it is what the rule avoids)."""
    import torch

    from repro_torch.core import clients

    chunk = clients.CLIENTS_PER_CHUNK
    batches, draws, _ = sc.topology._batches(sc, plan)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clients.CLIENTS_PER_CHUNK = chunk + 1
    try:
        clients.CLIENT_UPDATES["dtssl"].run_cohort(
            sc.cfg, state.global_tree, None, batches, draws, plan.lr)
    finally:
        clients.CLIENTS_PER_CHUNK = chunk
    torch.cuda.synchronize()
    print(f"[batched] the same cohort in chunks of {chunk + 1}: peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (PEAK_GIB "
          f"{PEAK_GIB})", flush=True)


def batched_path(dev, data):
    """[batched]: one Table-1 round from one state with parallel=True and
    with parallel=False on the card, then the same for a handover round
    whose plan pads a download group; loss and trees within the
    cross-check tolerances, launches by their formulas, and the peak
    memory of the batched Table-1 round at most PEAK_GIB. Returns the
    launches of the batched Table-1 round."""
    import torch

    from repro_torch.core.scenario import Scenario, run_round
    from repro_torch.trace_round import TABLE1

    cases = (("Table-1", dict(TABLE1), None),
             ("handover", dict(TABLE1, topology="handover",
                               topology_kwargs={}), _padded_state))
    for name, kw, prepare in cases:
        sc = Scenario(device=dev, data=data, **kw)
        state = prepare(sc) if prepare else sc.init_state()
        plan = _plan_of(sc, state)
        out = {}
        for parallel in (True, False):
            want = _round_launches(sc, plan, parallel)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            t = time.time()
            st, rec = run_round(state, sc, parallel=parallel)
            torch.cuda.synchronize()
            out[parallel] = (st, rec, time.time() - t, _counts(),
                             torch.cuda.max_memory_allocated() / 2**30)
            if out[parallel][3] != want:
                raise AssertionError(f"[batched] {name} parallel={parallel}:"
                                     f" launches {out[parallel][3]} != "
                                     f"{want}")
            _check_round("batched", rec, st)
        (st_p, r_p, t_p, l_p, peak_p), (st_s, r_s, t_s, _, peak_s) = \
            out[True], out[False]
        worst = _rows_diff(st_p, st_s, state)
        dloss = abs(r_p["loss"] - r_s["loss"])
        groups = [int(s.size) for _, s in getattr(plan, "down_groups", [])]
        print(f"[batched] {name} round {r_p['round']}"
              f"{f' (download groups {groups})' if groups else ''}: "
              f"parallel=True {t_p:.3f} s, peak {peak_p:.2f} GiB, loss "
              f"{r_p['loss']:.7f}, launches {l_p}; parallel=False {t_s:.3f} "
              f"s, peak {peak_s:.2f} GiB, loss {r_s['loss']:.7f}; trees max "
              f"abs {worst[0]:.3e}, relative to the update {worst[1]:.3e}",
              flush=True)
        same = {k: r_p[k] == r_s[k] for k in r_s if k != "loss"}
        if not (all(same.values()) and dloss <= CROSS_LOSS_TOL
                and worst[0] <= CROSS_MAX_ABS
                and worst[1] <= CROSS_REL_UPDATE):
            raise AssertionError(f"[batched] {name}: loss diff {dloss}, "
                                 f"trees {worst}, records {same}")
        if name == "Table-1":
            if peak_p > PEAK_GIB:
                raise AssertionError(f"[batched] peak memory {peak_p:.2f} "
                                     f"GiB > {PEAK_GIB} GiB")
            table1 = l_p
            _chunk_record(sc, state, plan)
        elif all(sc.topology.pad_to(g) == g for g in groups):
            raise AssertionError("[batched] handover round pads no group")
    return table1


def resume_path(dev, data):
    """[resume]: 4 rounds straight through, saving the state at round 2
    with save_state; then restore_state from disk and run rounds 2 and 3
    again. The restored state is the saved one bitwise; the schedule of
    the resumed rounds (ids, batch indices, velocities, lr) and the
    host_rng and gen_state after them are bitwise the straight run's;
    the trees (global, RSU models) within CROSS_MAX_ABS and the error
    feedback within it plus one code step (card runs are not bitwise
    repeatable). For Table-1, and for the handover with delta_int8
    (positions, RSU models, error feedback). Returns the launches of the
    straight Table-1 run."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.checkpoint.store import (_leaves, restore_state,
                                              save_state)
    from repro_torch.core.scenario import Scenario, run_round
    from repro_torch.trace_round import TABLE1

    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    cases = (("Table-1", dict(TABLE1)),
             ("handover delta_int8", dict(TABLE1, topology="handover",
                                          topology_kwargs={},
                                          codec="delta_int8")))
    scales = []
    restore = _recording_scales(scales)
    try:
        for name, kw in cases:
            del scales[:]
            sc = Scenario(device=dev, data=data, **kw)
            state, plans, recs, want = sc.init_state(), [], [], {}
            torch.cuda.synchronize()
            _zero_counts()
            for r in range(4):
                plans.append(_plan_of(sc, state))
                want = _add(want, _round_launches(sc, plans[-1]))
                if r == 2:
                    saved = state
                    path = save_state(os.path.join(ckpt_dir, "ckpt_2.npz"),
                                      state, scenario=sc)
                state, rec = run_round(state, sc)
                recs.append(rec)
            torch.cuda.synchronize()
            launches = _counts()
            if name == "Table-1":
                table1 = launches
            if launches != want:
                raise AssertionError(f"[resume] {name}: launches "
                                     f"{launches} != {want}")
            straight = state
            state = restore_state(path, scenario=sc)
            shutil.rmtree(ckpt_dir)
            exact = all(np.array_equal(np.asarray(
                a.cpu() if isinstance(a, torch.Tensor) else a), np.asarray(
                b.cpu() if isinstance(b, torch.Tensor) else b))
                for a, b in zip(_leaves(saved.to_tree()),
                                _leaves(state.to_tree())))
            schedule, resumed = exact, []
            for r in (2, 3):
                plan = _plan_of(sc, state)
                schedule &= (np.array_equal(plan.ids, plans[r].ids)
                             and torch.equal(plan.velocities,
                                             plans[r].velocities)
                             and plan.lr == plans[r].lr)
                idx = getattr(plan, "idx", None)
                schedule &= (np.array_equal(idx, plans[r].idx)
                             if idx is not None else all(
                                 np.array_equal(a, b) for a, b in zip(
                                     plan.batch_idx, plans[r].batch_idx)))
                state, rec = run_round(state, sc)
                resumed.append(rec["loss"])
                schedule &= all(rec[k] == recs[r][k]
                                for k in rec if k != "loss")
            schedule &= torch.equal(state.gen_state, straight.gen_state)
            schedule &= all(np.array_equal(state.host_rng[k],
                                           straight.host_rng[k])
                            for k in straight.host_rng)
            worst = _rows_diff(state, straight, saved)
            step = max(scales, default=0.0)
            ef_err = 0.0
            if straight.comms is not None:
                ef_err = _max_err(state.comms["ef"], straight.comms["ef"])
            print(f"[resume] {name}: saved at round 2, restored from disk "
                  f"(bitwise the saved state {exact}), rounds 2-3 again: "
                  f"schedule, host_rng and gen_state bitwise {schedule}; "
                  f"trees max abs diff {worst[0]:.3e} (relative to the "
                  f"update {worst[1]:.3e}), EF max abs {ef_err:.3e}, code "
                  f"step {step:.3e}; losses of rounds 2-3 "
                  f"{[r['loss'] for r in recs[2:]]} straight, {resumed} "
                  f"resumed; launches of the straight run {launches}",
                  flush=True)
            # a code may flip by one step under delta_int8 (step 0 else)
            if not (exact and schedule and worst[0] <= CROSS_MAX_ABS + step
                    and ef_err <= CROSS_MAX_ABS + step):
                raise AssertionError(f"[resume] {name}: exact {exact}, "
                                     f"schedule {schedule}, trees {worst}, "
                                     f"EF {ef_err}")
    finally:
        restore()
    return table1


def _engine_launches(sc, rounds: int) -> dict:
    """The launches `rounds` rounds of `sc` make through the campaign
    engine (core/engine.py), which trains the whole cohort in chunks of
    CLIENTS_PER_CHUNK (no groups, no padding): dt_loss one a chunk a
    local iteration; wagg 1 (SingleRSU), one per RSU group + 1 for the
    region (MultiRSU), n_rsus + 1 (the handover: every RSU's upload sum
    and the sync's merge, taken or not); q8_encode and q8_decode one each
    under delta_int8."""
    from repro_torch.core.clients import CLIENTS_PER_CHUNK

    cfg, topo = sc.cfg, sc.topology
    n = cfg.vehicles_per_round
    wagg = {"single": 1, "multi": min(getattr(topo, "n_rsus", 1), n) + 1,
            "handover": getattr(topo, "n_rsus", 1) + 1}[topo.name]
    q8 = int(cfg.codec == "delta_int8")
    per = {"wagg": wagg,
           "dt_loss": cfg.local_iters * -(-n // CLIENTS_PER_CHUNK),
           "q8_encode": q8, "q8_decode": q8, "rwkv6": 0,
           "dt_loss_wide": 0}
    return {k: v * rounds for k, v in per.items()}


# the port's kernels as the profiler names them
ENGINE_KERNELS = (("wagg", "wagg_kernel"), ("dt_loss", "dt_fwd"),
                  ("q8_encode", "q8_encode_kernel"),
                  ("q8_decode", "q8_decode_kernel"))


def _engine_profile(work) -> dict:
    """`work()` (a campaign) under torch.profiler: the host ms inside the
    engine's ``engine.round`` ranges; the round window, from the first
    such range's start to the last device event's end (the planning, the
    data stack's upload and the set-up before it left out); the device's
    busy ms in it (the union of its kernel and copy intervals) and its
    idle share; each port kernel's launches the device trace holds; the
    host ops with the most device time (a replay's kernels are listed
    under the ops that recorded them only in eager rounds)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        work()
        torch.cuda.synchronize()
    host_ms, first, intervals = 0.0, float("inf"), []
    seen = {name: 0 for name, _ in ENGINE_KERNELS}
    # ("Activity Buffer Request" and "Command Buffer Full" are the
    # profiler's and the launch queue's, not ops)
    ops_ = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CPU and e.self_device_time_total > 0
            and not e.key.startswith(("engine.", "Activity Buffer",
                                      "Command Buffer"))]
    for e in prof.events():
        if e.name.startswith("engine."):
            if e.name == "engine.round" and e.device_type == DeviceType.CPU:
                host_ms += e.time_range.elapsed_us() / 1e3
                first = min(first, e.time_range.start)
            continue
        if e.device_type == DeviceType.CUDA:
            intervals.append((e.time_range.start, e.time_range.end))
            for name, key in ENGINE_KERNELS:
                seen[name] += key in e.name
    last = max(hi for _, hi in intervals)
    busy_us, end = 0.0, first
    for lo, hi in sorted(intervals):
        busy_us += max(0.0, min(hi, last) - max(lo, end))
        end = max(end, hi)
    window_us = last - first
    top = sorted(ops_, key=lambda e: -e.self_device_time_total)[:6]
    return {"round_host_ms": host_ms, "window_ms": window_us / 1e3,
            "device_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / window_us, "kernels": seen,
            "top_ops_ms": [(e.key[:40], e.count,
                            round(e.self_device_time_total / 1e3, 1))
                           for e in top]}


def _sans_loss(hist) -> list:
    return [{k: v for k, v in r.items() if k != "loss"} for r in hist]


def _same_schedule(a, b, hist_a, hist_b) -> bool:
    """Records but the loss, host_rng, gen_state and the handover's host
    state of two campaigns' results, bitwise."""
    import numpy as np
    import torch

    same = (_sans_loss(hist_a) == _sans_loss(hist_b)
            and torch.equal(a.gen_state, b.gen_state) and a.round == b.round
            and all(np.array_equal(a.host_rng[k], b.host_rng[k])
                    for k in a.host_rng))
    return same and all(np.array_equal(a.topo[k], b.topo[k])
                        for k in ("positions", "blur_sum", "upload_count")
                        if k in a.topo)


def engine_path(dev, data):
    """[engine]: the campaign engine (`run_campaign`) at the Table-1
    setting. Returns the launches of its graph-mode campaigns, counters
    zeroed before each and each held to `_engine_launches`.
    * small rounds (16x16 images, batch 8) of every topology with every
      codec: a captured round, then a replayed one against the same round
      in mode="eager" from one state (the schedule bitwise, the trees and
      the error feedback within CROSS_MAX_ABS plus one code step);
    * Table 1: 4 rounds in mode="graph" with checkpoint_every=2 into
      build/chip_smoke_engine/ (removed after), published into a
      ModelStore: one capture across the two chunks, each published tree
      bitwise its checkpoint's, the last decoding bitwise to the final
      tree. 3 more rounds replayed with transfer_guard=True (any
      host-device sync raises), then one under torch.profiler (the
      kernels the device trace sees inside a replay). The graph freed,
      each chunk again in mode="eager" and through `run`, from the state
      the graph campaign started the chunk from (its checkpoint): the
      schedule, host_rng and gen_state bitwise across the three, the
      trees graph against eager and run against eager within
      CROSS_MAX_ABS at every chunk's end (each chunk is 2 rounds from one
      state: card runs are not bitwise repeatable, and 4 chained rounds
      at lr 0.9 grow the difference of two eager runs past 1e-2 while it
      stays below 0.1% of the update);
    * the handover: 5 rounds at the reference's defaults with delta_int8
      (the sync at round 4), graph against eager the same way in chunks
      of 2, 2 and 1: the schedule bitwise, the trees and the error
      feedback within CROSS_MAX_ABS plus one code step;
    * MultiRSU: 2 rounds on 2 RSUs in mode="graph" against `run`: the
      schedule bitwise, the trees within CROSS_MAX_ABS.
    Prints, per mode, seconds a round (between the publishes of chunks
    of one round, the set-up left out), host ms a round, the device's
    idle share in a profiled round, the peak memory, the graph pool's
    size and the capture's seconds."""
    import gc
    import shutil

    import numpy as np
    import torch

    from repro_torch.analysis.guards import (ENGINE_COMPILE_BOUNDS,
                                             assert_compile_bounds,
                                             track_compiles)
    from repro_torch.checkpoint.store import restore_state
    from repro_torch.comms.codecs import CODECS, decode_snapshot
    from repro_torch.convert import ravel
    from repro_torch.core import engine
    from repro_torch.core.scenario import Scenario, run, run_campaign
    from repro_torch.serve import ModelStore
    from repro_torch.trace_round import TABLE1

    gc.collect()
    torch.cuda.empty_cache()
    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke_engine")
    total, tracked_blocks = {}, {}

    def tracked(tag, sc, work):
        """`work()` inside `track_compiles`: the captures it counts must
        be the growth of `compile_counts(sc)` over the block."""
        before = engine.compile_counts(sc)["graph"]
        with track_compiles() as tracker:
            out = work()
        grown = engine.compile_counts(sc)["graph"] - before
        if tracker.graph_captures != grown:
            raise AssertionError(f"[engine] {tag}: track_compiles saw "
                                 f"{tracker.graph_captures} captures, "
                                 f"compile_counts grew by {grown}")
        tracked_blocks[tag] = (tracker.graph_captures,
                               tracker.kernel_builds)
        return out

    def campaign(tag, sc, state, rounds, **kw):
        """One counted campaign: (state, history, peak GiB, the seconds
        between consecutive publishes when publish_every=1)."""
        stamps = []
        if kw.get("publish_every") == 1:
            kw["publish"] = lambda r, t: stamps.append(time.perf_counter())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        state, hist = run_campaign(sc, state, rounds, **kw)
        torch.cuda.synchronize()
        launches, want = _counts(), _engine_launches(sc, rounds)
        if launches != want:
            raise AssertionError(f"[engine] {tag}: launches {launches} != "
                                 f"{want}")
        if kw.get("mode") == "graph":
            total.update(_add(total, launches))
        for rec in hist:
            _check_round("engine", rec, state)
        return (state, hist, torch.cuda.max_memory_allocated() / 2**30,
                [b - a for a, b in zip(stamps, stamps[1:])])

    def run_timed(sc, state, rounds):
        stamps = []
        state, hist = run(sc, state, rounds=rounds,
                          publish=lambda r, t: stamps.append(
                              time.perf_counter()))
        return state, hist, [b - a for a, b in zip(stamps, stamps[1:])]

    def graph_chunks(tag, sc, start, rounds, every, **kw):
        """The graph campaign with checkpoint_every=`every`: (its state
        and history, peak GiB, [(round, the state the graph campaign
        started each chunk from, restored from its checkpoint)], a line
        on the capture)."""
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        st, hist, peak, _ = campaign(tag, sc, start, rounds, mode="graph",
                                     checkpoint_every=every,
                                     checkpoint_dir=ckpt_dir, **kw)
        starts = [(0, start)] + [
            (r, restore_state(os.path.join(ckpt_dir, f"round_{r:06d}"),
                              scenario=sc))
            for r in range(every, rounds, every)]
        stats = engine.graph_stats(sc)
        line = (f"capture {stats['capture_s']:.3f} s, graph pool "
                f"{stats['pool_bytes'] / 2**30:.2f} GiB, compile_counts "
                f"{engine.compile_counts(sc)}, peak {peak:.2f} GiB")
        return st, hist, starts, line

    def held(tag, a, a_hist, b, b_hist, start, step=0.0):
        """Schedule bitwise, trees (and the error feedback) within
        CROSS_MAX_ABS (+ step); returns the worst differences."""
        schedule = _same_schedule(a, b, a_hist, b_hist)
        worst = _rows_diff(a, b, start)
        ef = (_max_err(a.comms["ef"], b.comms["ef"])
              if a.comms is not None else 0.0)
        if not (schedule and worst[0] <= CROSS_MAX_ABS + step
                and ef <= CROSS_MAX_ABS + step):
            raise AssertionError(f"[engine] {tag}: schedule {schedule}, "
                                 f"trees {worst}, EF {ef}, step {step}")
        return worst[0], worst[1], ef

    # -- every topology and codec, small ----------------------------------
    rs = np.random.RandomState(0)
    small = [rs.rand(24, 16, 16, 3).astype(np.float32) for _ in range(6)]
    worst = {}
    for topo, tkw in (("single", None), ("multi", {"n_rsus": 2}),
                      ("handover", {"n_rsus": 2, "rsu_range": 100.0,
                                    "sync_every": 2})):
        for codec in ("identity", "delta", "delta_int8"):
            tag = f"small {topo} {codec}"
            sc = Scenario(device=dev, data=small, n_vehicles=6,
                          vehicles_per_round=5, batch_size=8, rounds=4,
                          topology=topo, topology_kwargs=tkw, codec=codec)
            # round 0 captures, round 1 replays; round 1 eagerly from the
            # same state
            s1 = campaign(tag, sc, sc.init_state(), 1, mode="graph")[0]
            st_g, h_g = campaign(tag, sc, s1, 1, mode="graph")[:2]
            counts = engine.compile_counts(sc)
            assert_compile_bounds(counts, what=f"[engine] {tag}")
            st_e, h_e = campaign(tag, sc, s1, 1, mode="eager")[:2]
            step = 0.0 if s1.comms is None else 2 * max(
                float(st.comms["ef"].abs().max()) for st in (st_g, st_e))
            worst[f"{topo} {codec}"] = held(tag, st_g, h_g, st_e, h_e, s1,
                                            step)[0]
            if counts != ENGINE_COMPILE_BOUNDS:
                raise AssertionError(f"[engine] {tag}: compile_counts "
                                     f"{counts}")
            engine.reset_engine_caches()
    print(f"[engine] small rounds (16x16 images, batch 8), a replayed "
          f"round against the eager one from one state, schedule bitwise, "
          f"trees max abs: {worst}", flush=True)

    # -- Table 1 ---------------------------------------------------------
    sc = Scenario(device=dev, data=data, **TABLE1)
    store = ModelStore()
    st_g, h_g, starts, line = tracked(
        "Table-1 graph", sc, lambda: graph_chunks(
            "Table-1 graph", sc, sc.init_state(), 4, 2,
            publish=store.publish))
    # where the graph campaign ended each chunk: the next one's start
    ends = [s for _, s in starts[1:]] + [st_g]
    snap = decode_snapshot(CODECS[store.codec], store.get(4).delta_payload,
                           store.get(2).served_tree)
    published = (store.rounds() == [2, 4]
                 and torch.equal(ravel(store.get(2).tree),
                                 ravel(ends[0].global_tree))
                 and torch.equal(ravel(store.get(4).tree),
                                 ravel(st_g.global_tree))
                 and torch.equal(ravel(snap), ravel(st_g.global_tree)))
    counts = engine.compile_counts(sc)
    st_w, _, _, t_g = tracked(
        "Table-1 guarded", sc, lambda: campaign(
            "Table-1 graph, guarded", sc, st_g, 3, mode="graph",
            transfer_guard=True, publish_every=1))
    if tracked_blocks["Table-1 guarded"] != (0, 0):
        raise AssertionError(f"[engine] the guarded replays captured or "
                             f"built: {tracked_blocks['Table-1 guarded']}")
    prof_g = _engine_profile(lambda: run_campaign(sc, st_w, 1, mode="graph"))
    counts_after = engine.compile_counts(sc)
    engine.reset_engine_caches()
    worst, t_e, t_r, peak_e = [], [], [], 0.0
    for (r0, s0), end in zip(starts, ends):
        k = 2
        st_e, h_e, peak, dt = campaign("Table-1 eager", sc, s0, k,
                                       mode="eager", publish_every=1)
        st_r, h_r, dt_r = run_timed(sc, s0, k)
        peak_e, t_e, t_r = max(peak_e, peak), t_e + dt, t_r + dt_r
        worst.append((held("Table-1 graph vs eager", end, h_g[r0:r0 + k],
                           st_e, h_e, s0),
                      held("Table-1 run vs eager", st_r, h_r, st_e, h_e,
                           s0)))
    prof_e = _engine_profile(lambda: run_campaign(sc, st_e, 1, mode="eager"))
    one = _engine_launches(sc, 1)
    seen = dict(prof_g["kernels"])
    print(f"[engine] Table-1 graph: {line}; seconds a round (warm, "
          f"transfer_guard) {[round(t, 4) for t in t_g]}; profiled replay: "
          f"host {prof_g['round_host_ms']:.3f} ms, round window "
          f"{prof_g['window_ms']:.3f} ms, device busy "
          f"{prof_g['device_busy_ms']:.3f} ms, idle "
          f"{prof_g['idle_share']:.4f}, kernels seen on the device {seen}",
          flush=True)
    print(f"[engine] Table-1 eager round, device ms by op: "
          f"{prof_e['top_ops_ms']}", flush=True)
    print(f"[engine] Table-1 eager: seconds a round "
          f"{[round(t, 4) for t in t_e]}, peak {peak_e:.2f} GiB; profiled "
          f"round: host {prof_e['round_host_ms']:.3f} ms, round window "
          f"{prof_e['window_ms']:.3f} ms, device busy "
          f"{prof_e['device_busy_ms']:.3f} ms, idle "
          f"{prof_e['idle_share']:.4f}, kernels seen {prof_e['kernels']}; "
          f"run(parallel=True) seconds a round {[round(t, 4) for t in t_r]}",
          flush=True)
    print(f"[engine] Table-1: schedule, host_rng and gen_state bitwise "
          f"across graph, eager and run at rounds 2 and 4; trees at each "
          f"chunk's end (max abs, relative to the update), graph vs eager "
          f"{[w[0][:2] for w in worst]}, run vs eager "
          f"{[w[1][:2] for w in worst]}; graph losses "
          f"{[r['loss'] for r in h_g]}; publishes bitwise the checkpoints "
          f"and the final tree {published}; compile_counts {counts} after "
          f"the campaign, {counts_after} after the warm ones", flush=True)
    if not any(seen.values()):
        print("[engine] the profiler saw no kernel inside the replayed "
              "graph: launches rest on the replay counts", flush=True)
    elif seen != {k: one[k] for k in seen}:
        raise AssertionError(f"[engine] kernels in one profiled replay "
                             f"{seen} != {one}")
    assert_compile_bounds(counts, what="[engine] Table-1 campaign")
    assert_compile_bounds(counts_after, what="[engine] Table-1 warm")
    if not (published
            and counts == counts_after == ENGINE_COMPILE_BOUNDS):
        raise AssertionError(f"[engine] Table-1: published {published}, "
                             f"compile_counts {counts} {counts_after}")
    del st_g, st_w, st_e, st_r, starts, ends, store, snap
    engine.reset_engine_caches()

    # -- the handover, delta_int8 ----------------------------------------
    sc = Scenario(device=dev, data=data, **dict(
        TABLE1, topology="handover", topology_kwargs={}, codec="delta_int8"))
    st_g, h_g, starts, line = tracked(
        "handover graph", sc, lambda: graph_chunks(
            "handover graph", sc, sc.init_state(), 5, 2))
    shutil.rmtree(ckpt_dir)
    ends = [s for _, s in starts[1:]] + [st_g]
    st_w, _, _, t_g = campaign("handover graph, warm", sc, st_g, 2,
                               mode="graph", publish_every=1)
    prof_g = _engine_profile(lambda: run_campaign(sc, st_w, 1, mode="graph"))
    del st_w
    engine.reset_engine_caches()
    scales, worst, t_e = [], [], []
    restore = _recording_scales(scales)
    try:
        for (r0, s0), end in zip(starts, ends):
            k = min(2, 5 - r0)
            del scales[:]
            st_e, h_e, peak_e, dt = campaign("handover eager", sc, s0, k,
                                             mode="eager", publish_every=1)
            t_e += dt
            # one code step of the largest block scale either side
            # encoded with (the graph's from its residual: |ef| <= scale/2)
            step = max(max(scales), 2 * float(end.comms["ef"].abs().max()))
            worst.append(held("handover graph vs eager", end,
                              h_g[r0:r0 + k], st_e, h_e, s0, step)
                         + (step,))
    finally:
        restore()
    syncs = [r["round"] for r in h_g if r["synced"]]
    handovers = sum(r["n_handovers"] for r in h_g)
    prof_e = _engine_profile(lambda: run_campaign(sc, st_e, 1, mode="eager"))
    print(f"[engine] handover delta_int8 graph: {line}; seconds a round "
          f"(warm) {[round(t, 4) for t in t_g]}; profiled replay: host "
          f"{prof_g['round_host_ms']:.3f} ms, round window "
          f"{prof_g['window_ms']:.3f} ms, idle {prof_g['idle_share']:.4f}, "
          f"kernels seen {prof_g['kernels']}; eager round, device ms by op "
          f"{prof_e['top_ops_ms']}", flush=True)
    print(f"[engine] handover delta_int8: eager seconds a "
          f"round {[round(t, 4) for t in t_e]}, peak {peak_e:.2f} GiB; "
          f"schedule bitwise; {handovers} handovers, syncs at {syncs}; at "
          f"rounds 2, 4, 5 (trees max abs, relative, EF max abs, code step) "
          f"{worst}; graph losses {[r['loss'] for r in h_g]}", flush=True)
    if not (handovers and syncs == [4]):
        raise AssertionError(f"[engine] handover: {handovers} handovers, "
                             f"syncs at {syncs}; expected handovers and the "
                             f"sync at round 4")
    del st_g, st_e, starts, ends
    engine.reset_engine_caches()

    # -- MultiRSU ---------------------------------------------------------
    sc = Scenario(device=dev, data=data, **dict(
        TABLE1, topology="multi", topology_kwargs={"n_rsus": 2}))
    start = sc.init_state()
    st_g, h_g, peak_g, _ = tracked(
        "multi graph", sc, lambda: campaign("multi graph", sc, start, 2,
                                            mode="graph"))
    stats = engine.graph_stats(sc)
    engine.reset_engine_caches()
    st_r, h_r = run(sc, start, rounds=2)
    worst = held("multi graph vs run", st_g, h_g, st_r, h_r, start)
    print(f"[engine] MultiRSU graph: capture {stats['capture_s']:.3f} s, "
          f"graph pool {stats['pool_bytes'] / 2**30:.2f} GiB, peak "
          f"{peak_g:.2f} GiB; against run: schedule bitwise, rsu_sizes "
          f"{[r['rsu_sizes'] for r in h_g]}, trees max abs {worst[0]:.3e} "
          f"(relative {worst[1]:.3e}); graph launches of the phase {total}",
          flush=True)
    print(f"[engine] track_compiles (graph captures, kernel builds) by "
          f"block, captures equal to compile_counts' growth: "
          f"{tracked_blocks}", flush=True)
    engine.reset_engine_caches()
    return total


def _probe_cpu_check(dev, f_tr, y_tr, f_te, y_te):
    """Both probes on the card against the CPU on the same features, image
    by image: the kNN votes and the linear probe's weights and logits
    within their tolerances, and the same predicted class wherever the
    CPU's decision is farther from a tie than those tolerances can move
    it (a 20th and 21st neighbour, or the two leading classes, closer
    than twice the error). Returns the CPU's two top-1, a note, and the
    number of near-tie images of either probe."""
    import numpy as np
    import torch

    from repro_torch.eval.probe import knn_votes, linear_probe_fit
    tr, te = torch.from_numpy(f_tr), torch.from_numpy(f_te)
    sims = te @ tr.T
    delta = _max_err((te.to(dev) @ tr.to(dev).T).cpu(), sims)
    v_c = knn_votes(f_tr, y_tr, f_te, device="cpu")
    v_g = knn_votes(f_tr, y_tr, f_te, device=dev).cpu()
    near = sims.topk(21, dim=1).values
    boundary = (near[:, 19] - near[:, 20]) <= 2 * delta
    rel = 2 * delta / 0.1 + PROBE_EXP_REL
    err = ((v_g - v_c).abs().amax(dim=1) / v_c.amax(dim=1))[~boundary]
    top2 = v_c.topk(2, dim=1).values
    knn_tie = boundary | ((top2[:, 0] - top2[:, 1]) <= 2 * rel * top2[:, 0])
    knn_diff = (v_g.argmax(1) != v_c.argmax(1)) & ~knn_tie
    W_c, b_c = linear_probe_fit(f_tr, y_tr, device="cpu")
    W_g, b_g = linear_probe_fit(f_tr, y_tr, device=dev)
    w_err = _max_err(W_g.cpu(), W_c) / float(W_c.abs().max())
    L_c = te @ W_c + b_c
    L_g = (te.to(dev) @ W_g + b_g).cpu()   # the card's logits
    e = float((L_g - L_c).abs().max())
    top2 = L_c.topk(2, dim=1).values
    lin_tie = (top2[:, 0] - top2[:, 1]) <= 2 * e
    lin_diff = (L_g.argmax(1) != L_c.argmax(1)) & ~lin_tie
    note = (f"card vs cpu on the same features: sims max abs {delta:.3e}, "
            f"kNN votes relative {float(err.max()):.3e} (bound {rel:.3e}), "
            f"{int(knn_tie.sum())} near-tie images; linear weights "
            f"relative {w_err:.3e}, logits max abs {e:.3e}, "
            f"{int(lin_tie.sum())} near-tie images")
    if not (delta <= PROBE_SIM_TOL and float(err.max()) <= rel
            and w_err <= PROBE_LIN_REL
            and e <= PROBE_LIN_REL * float(L_c.abs().max())) \
            or knn_diff.any() or lin_diff.any():
        raise AssertionError(f"[probe] {note}; {int(knn_diff.sum())} kNN "
                             f"and {int(lin_diff.sum())} linear predictions "
                             f"differ away from a tie")
    y = torch.from_numpy(np.asarray(y_te))
    return (float((v_c.argmax(1) == y).double().mean()),
            float((L_c.argmax(1) == y).double().mean()), note,
            int((knn_tie | lin_tie).sum()))


def probe_path(dev, sc, state):
    """[probe]: the kNN and linear probes of the [main] final tree on the
    dataset's 85/15 split (2,000 train and 1,000 test images, as
    examples/train_federated_ssl.py), card features against CPU features
    on 256 images, and both probes against the CPU on the card's
    features (`_probe_cpu_check`)."""
    import numpy as np
    import torch

    from repro_torch.eval.probe import encode, knn_top1, linear_probe_top1

    x, y = sc.dataset
    split = int(0.85 * len(x))
    x_tr, y_tr, x_te, y_te = x[:2000], y[:2000], x[split:split + 1000], \
        y[split:split + 1000]
    encode(state.global_tree, x_tr[:256], device=dev)      # warm-up
    torch.cuda.synchronize()
    _zero_counts()
    t = time.time()
    f_tr = encode(state.global_tree, x_tr, device=dev)
    f_te = encode(state.global_tree, x_te, device=dev)
    t_enc = time.time() - t
    t = time.time()
    knn = knn_top1(f_tr, y_tr, f_te, y_te, device=dev)
    t_knn = time.time() - t
    t = time.time()
    lin = linear_probe_top1(f_tr, y_tr, f_te, y_te, device=dev)
    t_lin = time.time() - t
    launches = _counts()
    f_cpu = encode(state.global_tree, x_tr[:256], device="cpu")
    err = float(np.abs(f_tr[:256] - f_cpu).max())
    knn_c, lin_c, note, _ = _probe_cpu_check(dev, f_tr, y_tr, f_te, y_te)
    # and on random unit features with the same labels, where few images
    # are near ties
    rs = np.random.RandomState(0)
    g_tr, g_te = (rs.randn(len(f), f.shape[1]).astype(np.float32)
                  for f in (f_tr, f_te))
    g_tr /= np.linalg.norm(g_tr, axis=1, keepdims=True)
    g_te /= np.linalg.norm(g_te, axis=1, keepdims=True)
    _, _, spread, ties = _probe_cpu_check(dev, g_tr, y_tr, g_te, y_te)
    print(f"[probe] random unit features: {spread}", flush=True)
    if ties > PROBE_SPREAD_TIES:
        raise AssertionError(f"[probe] {ties} near-tie images on random "
                             f"features (at most {PROBE_SPREAD_TIES})")
    # the features' spread: |mean feature| is 1 when all point one way;
    # the test split's largest class share is what one constant guess
    # scores
    cone = float(np.linalg.norm(f_tr.mean(axis=0)))
    major = float(np.bincount(y_te).max() / len(y_te))
    print(f"[probe] encode {len(x_tr)} train and {len(x_te)} test images "
          f"{t_enc:.3f} s on the card; kNN top-1 {knn:.4f} ({t_knn:.3f} "
          f"s; cpu on the card's features {knn_c:.4f}), linear top-1 "
          f"{lin:.4f} ({t_lin:.3f} s; cpu {lin_c:.4f}); {note}; card vs "
          f"cpu features (256 images) max abs {err:.3e}; |mean train "
          f"feature| "
          f"{cone:.4f}, largest test class share {major:.4f}; launches "
          f"{launches}", flush=True)
    if not (np.isfinite(f_tr).all() and np.isfinite(f_te).all()
            and f_tr.shape == (len(x_tr), 512)
            and f_te.shape == (len(x_te), 512)):
        raise AssertionError("[probe] features not finite or misshapen")
    if not (err <= PROBE_FEAT_TOL and 0.0 <= knn <= 1.0
            and 0.0 <= lin <= 1.0) or any(launches.values()):
        raise AssertionError(f"[probe] feature err {err}, knn {knn}, linear "
                             f"{lin}, launches {launches}")


def serve_path(store):
    """95 vehicles against an RSUServer driven by drain_once, every reply
    kind; returns the counts of reply kinds."""
    import torch

    from repro_torch.convert import ravel
    from repro_torch.serve import RSUServer, ServePolicy, apply_reply

    latest = store.latest_round
    server = RSUServer(store, ServePolicy(max_lag=1, queue_limit=64),
                       start=False)
    # held rounds cycle over every published round: the latest is
    # "current", one behind is a 1-hop "delta", older ones are "full",
    # and whatever exceeds the 64-deep queue is "shed"
    held = [i % (latest + 1) for i in range(95)]
    torch.cuda.synchronize()
    _zero_counts()
    t = time.time()
    pends = [server.submit(h) for h in held]
    while server.drain_once(block=False):
        pass
    kinds, hops, bad = {}, 0, 0
    for h, pend in zip(held, pends):
        rep = pend.result(timeout=0)
        kind = rep.kind if rep.status == "ok" else rep.status
        kinds[kind] = kinds.get(kind, 0) + 1
        if rep.status != "ok":
            continue
        tree = apply_reply(rep, store.get(h).served_tree, codec=store.codec)
        hops += len(rep.payloads) if rep.kind == "delta" else 0
        if not torch.equal(ravel(tree),
                           ravel(store.get(rep.round).served_tree)):
            bad += 1
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = _counts()
    st = server.stats()
    lost = st["submitted"] - st["served"] - st["shed"]
    print(f"[serve] 95 vehicles: replies {kinds}, {hops} delta hops "
          f"applied, {bad} trees not bitwise the served tree, {lost} lost; "
          f"launches {launches}; {wall:.3f} s", flush=True)
    if set(kinds) != {"current", "delta", "full", "shed"}:
        raise AssertionError(f"serve: reply kinds {kinds} miss one")
    if bad or lost or st["submitted"] != 95:
        raise AssertionError(f"serve: {bad} mismatches, {lost} lost, "
                             f"{st['submitted']} submitted")
    if launches["q8_decode"] != hops or launches["q8_encode"] != 0:
        raise AssertionError(f"serve: launches {launches}, {hops} hops")
    return kinds


def threaded_serve(sc, state):
    """A short threaded pass through launch/serve.py's serve_campaign:
    parity and accounting (no launch counts: fetchers decode at once)."""
    from repro_torch.launch.serve import serve_campaign

    res = serve_campaign(sc, rounds=2, vehicles=200, fetchers=8,
                         codec="delta_int8", max_lag=2, queue_limit=64,
                         state=state)
    st = res["server"]
    print(f"[serve] threaded: 2 Table-1 rounds trained while 8 fetchers "
          f"issued 200 fetches: {res['served']} served, {res['shed']} shed, "
          f"{res['served_per_s']:.1f} served/s over {res['wall_s']:.2f} s, "
          f"fetch p50 {res['p50_us'] / 1e3:.3f} ms, p99 "
          f"{res['p99_us'] / 1e3:.3f} ms, batches {st['batches']}, "
          f"{res['mismatches']} mismatches, {res['lost']} lost", flush=True)
    if res["mismatches"] or res["lost"] or not res["served"]:
        raise AssertionError(f"threaded serve: {res['mismatches']} "
                             f"mismatches, {res['lost']} lost, "
                             f"{res['served']} served")


def lossless_round(dev, data, state):
    """One more round from `state` with codec="delta" and with "identity":
    the trees are bitwise equal (cuDNN held to deterministic algorithms,
    so that the two rounds' convolutions sum in the same order)."""
    import torch

    from repro_torch.convert import ravel
    from repro_torch.core.scenario import Scenario, run_round
    from repro_torch.trace_round import TABLE1

    state = state.replace(comms=None)
    trees = []
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for codec in ("delta", "identity"):
            sc = Scenario(device=dev, codec=codec, data=data, **TABLE1)
            st, _ = run_round(state, sc)
            trees.append(ravel(st.global_tree))
    finally:
        torch.backends.cudnn.deterministic = prev
    torch.cuda.synchronize()
    same = torch.equal(trees[0], trees[1])
    print(f"[comms] one round with codec=delta and with codec=identity "
          f"from round {state.round}: trees bitwise equal {same}",
          flush=True)
    if not same or torch.equal(trees[0], ravel(state.global_tree)):
        raise AssertionError("delta round is not bitwise the identity "
                             "round, or did not train")


def _rwkv6_work(bh: int, s: int, d: int, state0: bool):
    """(bytes, flops) the rwkv6 recurrence needs for these inputs: r, k,
    v, logw and u read once, o and the state written once (state0 read
    once if given); the operations are `kernels.rwkv6.work_flops`."""
    from repro_torch.kernels.rwkv6 import work_flops
    bytes_ = 4 * (bh * s * d * 5 + bh * d + bh * d * d * (2 if state0 else 1))
    return bytes_, work_flops(bh, s, d)


def rwkv6_kernel_check(dev):
    """The rwkv6 kernel against its plain chunked version on the card."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rwkv6 as rwkv6_kernel

    g = torch.Generator(device=dev).manual_seed(2)
    bh, d = ZOO_B * RWKV_H, RWKV_D

    def inputs(s):
        r, k, v = (torch.randn((bh, s, d), generator=g, device=dev) * 0.5
                   for _ in range(3))
        lw = torch.clamp(-torch.exp(torch.randn((bh, s, d), generator=g,
                                                device=dev) * 0.3 - 1.0),
                         -4.0, -1e-4)
        return r, k, v, lw

    u = torch.randn((bh, d), generator=g, device=dev) * 0.3
    s0 = torch.randn((bh, d, d), generator=g, device=dev) * 0.3
    errs = []
    for s, st0 in ((ZOO_S, None), (ZOO_S - 5, s0), (37, s0)):
        r, k, v, lw = inputs(s)
        o, st = ops.rwkv6(r, k, v, lw, u, st0)
        o_p, st_p = ops.rwkv6_plain(r, k, v, lw, u, st0)
        err = max(_max_err(o, o_p), _max_err(st, st_p))
        rows = 4 if s > 64 else bh      # the sequential oracle: a few rows
        so, sst = ref.rwkv6_ref(r[:rows], k[:rows], v[:rows], lw[:rows],
                                u[:rows], None if st0 is None else st0[:rows])
        seq_err = max(_max_err(o[:rows], so), _max_err(st[:rows], sst))
        print(f"[zoo] rwkv6 ({bh}, {s}, {d}) state0="
              f"{'yes' if st0 is not None else 'no'}: max abs err vs plain "
              f"{err:.3e}, vs sequential oracle ({rows} rows) "
              f"{seq_err:.3e}", flush=True)
        if not (err <= RWKV6_TOL and seq_err <= RWKV6_TOL):
            raise AssertionError(f"rwkv6 S={s}: err {err}, oracle err "
                                 f"{seq_err} > {RWKV6_TOL}")
        errs.append(max(err, seq_err))
        if s == ZOO_S:
            main_in = (r, k, v, lw)
    r, k, v, lw = main_in
    # the projections' (B, S, H, D) layout, read in place by strides
    four = [t.view(ZOO_B, ZOO_S, RWKV_H, d) for t in main_in]
    o4, st4 = ops.rwkv6(*four, u[:RWKV_H], s0.view(ZOO_B, RWKV_H, d, d))
    rows = [t.transpose(1, 2).reshape(bh, ZOO_S, d) for t in four]
    o3, st3 = ops.rwkv6(*rows, u[:RWKV_H].repeat(ZOO_B, 1), s0)
    torch.cuda.synchronize()
    if not (torch.equal(o4.transpose(1, 2).reshape(bh, ZOO_S, d), o3)
            and torch.equal(st4.view(bh, d, d), st3)):
        raise AssertionError("rwkv6: (B, S, H, D) call is not bitwise the "
                             "(BH, S, D) call")
    del o4, st4, o3, st3, rows, four
    ms = _time_ms(lambda: ops.rwkv6(r, k, v, lw, u))
    dev_ms = _device_ms(lambda: ops.rwkv6(r, k, v, lw, u), "rwkv6_kernel",
                        iters=20)
    plain_ms = _time_ms(lambda: ops.rwkv6_plain(r, k, v, lw, u), iters=3,
                        warmup=1)
    bound_ms, bound_by = _bound(*_rwkv6_work(bh, ZOO_S, d, False))
    attrs = rwkv6_kernel.kernel_attributes(d)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"[zoo] rwkv6 ({bh}, {ZOO_S}, {d}): (B, S, H, D) layout bitwise "
          f"the row layout; kernel {ms:.4f} ms (device {dev_ms:.4f} ms), "
          f"plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}); {attrs['regs']} registers "
          f"and {attrs['local_bytes']} local bytes a thread, "
          f"{attrs['blocks_per_sm']} blocks of {attrs['threads']} threads an "
          f"SM ({bh} rows over {sms} SMs in "
          f"{-(-bh // max(1, attrs['blocks_per_sm'] * sms))} wave(s)), "
          f"{attrs['steps_per_slab']} steps a slab", flush=True)
    return {"name": "rwkv6", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rwkv6.cu",
            "replaces": "src/repro/kernels/rwkv6.py:28",
            "max_abs_err": max(errs), "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "regs": attrs["regs"], "local_bytes": attrs["local_bytes"],
            "blocks_per_sm": attrs["blocks_per_sm"]}


def zoo_cross_check(dev):
    """rwkv6-1.6b-smoke in float32: prefill + 4 decode steps on the card
    and on the CPU; decode after a prefill equals a full forward."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.convert import tree_map
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T

    cfg = get_config("rwkv6-1.6b-smoke")
    b, s, n = 2, 37, 4
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        1, cfg.vocab_size, (b, s + n)))
    shape = InputShape("cross", s + n, b, "prefill")
    outs = []
    for d in (dev, torch.device("cpu")):
        p = tree_map(lambda t: t.to(d), params)
        tk = toks.to(d)
        last, cache = steps.make_prefill_step(cfg, shape, torch.float32)(
            p, {"tokens": tk[:, :s]})
        logits = [last]
        decode = steps.make_decode_step(cfg)
        for i in range(n):
            lg, cache = decode(p, {"tokens": tk[:, s + i:s + i + 1],
                                   "positions": torch.full((b,), s + i,
                                                           device=d),
                                   "cache": cache})
            logits.append(lg)
        outs.append([t.cpu() for t in logits + [cache["state"]]])
        if d == dev:     # decode after the prefill == full forward
            full, _, _ = T.forward(cfg, p, tk[:, :s + 1])
            dec_err = _max_err(logits[1][:, :cfg.vocab_size],
                               full[:, -1, :cfg.vocab_size])
    err = max(_max_err(a[:, :cfg.vocab_size] if a.dim() == 2 else a,
                       c[:, :cfg.vocab_size] if c.dim() == 2 else c)
              for a, c in zip(*outs))
    print(f"[zoo] {cfg.name} float32, prefill {b}x{s} + {n} decode steps: "
          f"card vs cpu max abs diff {err:.3e} (logits and states); decode "
          f"vs full forward on the card {dec_err:.3e}", flush=True)
    if not (err <= ZOO_CROSS_TOL and dec_err <= ZOO_CROSS_TOL):
        raise AssertionError(f"zoo cross-check: card vs cpu {err}, decode "
                             f"vs full {dec_err} > {ZOO_CROSS_TOL}")


def _profile(work, ranges=()) -> dict:
    """`work()` (which returns its own synchronised wall seconds) under
    torch.profiler: device time by kernel and by host op, the rwkv6
    kernel's share, the device's idle share of the wall time, and for
    each record_function range named in `ranges` the device time of the
    kernels launched inside it (``<name>_ms``) and its count."""
    from torch.autograd import DeviceType

    wall, events = _profiled(work)
    spans = {}
    for name in ranges:     # the host range: its child kernels' time
        hits = [e for e in events if e.key == name
                and e.device_type == DeviceType.CPU]
        spans[f"{name}_ms"] = sum(e.device_time_total for e in hits) / 1e3
        spans[f"{name}_count"] = sum(e.count for e in hits)
    # kernels, not the ranges' own spans on the device's timeline
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.key not in ranges]
    ops_ = [e for e in events if e.device_type == DeviceType.CPU
            and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    rwkv = sum(e.self_device_time_total for e in kernels
               if "rwkv6_kernel" in e.key) / 1e3

    def top(evs, n):
        evs = sorted(evs, key=lambda e: -e.self_device_time_total)[:n]
        return [(e.key[:60], e.count, round(e.self_device_time_total / 1e3,
                                            3)) for e in evs]

    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "rwkv6_ms": rwkv, "rwkv6_share": rwkv / busy if busy else None,
            "idle_share": 1.0 - busy / (wall * 1e3) if busy else None,
            "kernel_launches": sum(e.count for e in kernels),
            "top_ops": top(ops_, 10), "top_kernels": top(kernels, 6),
            **spans}


def _plain_prefill(cfg, params, prompts, dtype, eps: float = 0.0):
    """The full-width prefill with every rwkv6 call through the plain
    chunked version on the card, its outputs o scaled by (1 +- eps) with a
    seeded random sign when eps > 0. Returns (last logits, cache)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import decode as dec

    g = torch.Generator(device=prompts.device).manual_seed(123)

    def plain(*args):
        o, st = ops.rwkv6_plain(*args)
        if eps:
            sign = torch.randint(0, 2, o.shape, generator=g,
                                 device=o.device) * 2.0 - 1.0
            o = o * (1.0 + eps * sign)
        return o, st

    saved = ops.rwkv6
    ops.rwkv6 = plain
    try:
        _zero_counts()
        last, cache, _ = dec.run_prefill(cfg, params, prompts,
                                         ZOO_S + ZOO_DECODE, dtype)
        if _counts()["rwkv6"]:
            raise AssertionError("zoo: the plain prefill launched rwkv6")
    finally:
        ops.rwkv6 = saved
    return last[:, :cfg.vocab_size], cache["state"]


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def zoo_full_width(dev):
    """rwkv6-1.6b at full width through launch/decode.py's functions:
    16 x 2048 prefill, 64 greedy decode steps in bfloat16, held against
    the plain version in bfloat16 and in float32; returns the prefill's
    launches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import leaves_with_paths
    from repro_torch.launch import decode as dec

    cfg = get_config("rwkv6-1.6b")
    v = cfg.vocab_size
    total = ZOO_S + ZOO_DECODE
    bf16 = torch.bfloat16
    t = time.time()
    params = dec.init_model(cfg, 0, bf16, dev)
    prompts = dec.random_prompts(cfg, ZOO_B, ZOO_S, 0, dev)
    n_params = sum(x.numel() for _, x in leaves_with_paths(params))
    last, cache, t_warm = dec.run_prefill(cfg, params, prompts, total, bf16)
    dec.run_decode(cfg, params, last, cache, ZOO_S, 2)
    print(f"[zoo] {cfg.name}: {n_params:,} parameters (bfloat16), set-up "
          f"and warm-up {time.time() - t:.2f} s (first prefill "
          f"{t_warm:.3f} s)", flush=True)
    del last, cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    last, cache, t_pre = dec.run_prefill(cfg, params, prompts, total, bf16)
    pre = _counts()
    _zero_counts()
    toks, _, t_dec = dec.run_decode(cfg, params, last, cache, ZOO_S,
                                    ZOO_DECODE)
    dcd = _counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[zoo] prefill {ZOO_B}x{ZOO_S}: {t_pre:.4f} s "
          f"({ZOO_B * ZOO_S / t_pre:.0f} tok/s); {ZOO_DECODE} decode steps "
          f"x {ZOO_B}: {t_dec:.4f} s, {t_dec * 1e3 / ZOO_DECODE:.3f} ms per "
          f"step, {ZOO_DECODE * ZOO_B / t_dec:.1f} tok/s; peak memory "
          f"{peak:.2f} GiB; launches prefill {pre}, decode {dcd}",
          flush=True)
    want_pre = {k: 0 for k in pre}
    want_pre["rwkv6"] = cfg.n_layers
    if pre != want_pre or any(dcd.values()):
        raise AssertionError(f"zoo launches: prefill {pre} (want "
                             f"{want_pre}), decode {dcd} (want none)")
    if not bool(torch.isfinite(last[:, :v]).all()) \
            or tuple(toks.shape) != (ZOO_B, ZOO_DECODE + 1) \
            or not bool(((toks >= 0) & (toks < v)).all()) \
            or not bool(torch.isfinite(cache["state"]).all()):
        raise AssertionError("zoo: logits or states not finite, or tokens "
                             "out of the vocabulary")
    # the kernel in place: the same prefill through the plain version,
    # and the plain version against itself perturbed by 2 float32 ULP
    t = time.time()
    last_p, st_p = _plain_prefill(cfg, params, prompts, bf16)
    t_plain = time.time() - t
    last_f, st_f = _plain_prefill(cfg, params, prompts, bf16, ZOO_ULP_EPS)
    layer0 = _max_err(cache["state"][0], st_p[0])
    k_lg, k_st = _rel(last[:, :v], last_p), _rel(cache["state"], st_p)
    f_lg, f_st = _rel(last_f, last_p), _rel(st_f, st_p)
    by_layer = [round(_rel(cache["state"][i], st_p[i]), 5)
                for i in range(0, cfg.n_layers, 4)]
    agree = float((last[:, :v].argmax(-1) == last_p.argmax(-1)).float()
                  .mean())
    print(f"[zoo] bfloat16 kernel vs plain prefill (plain {t_plain:.3f} s): "
          f"layer-0 state max abs {layer0:.3e}; last logits relative L2 "
          f"{k_lg:.4e} (2-ULP floor {f_lg:.4e}), final states {k_st:.4e} "
          f"(floor {f_st:.4e}); states by layer 0,4,..,20 {by_layer}; "
          f"greedy picks equal {agree:.4f}", flush=True)
    if not (layer0 <= RWKV6_TOL and k_lg <= ZOO_BF16_FLOOR_X * f_lg
            and k_st <= ZOO_BF16_FLOOR_X * f_st):
        raise AssertionError(f"zoo bfloat16: layer-0 state {layer0}, "
                             f"logits {k_lg} vs floor {f_lg}, states {k_st} "
                             f"vs floor {f_st}")
    del last_p, st_p, last_f, st_f
    prof = _profile(lambda: dec.run_prefill(cfg, params, prompts, total,
                                            bf16)[2])
    print(f"[zoo] profiled prefill: {json.dumps(prof)}", flush=True)
    prof = _profile(lambda: dec.run_decode(cfg, params, last, cache, ZOO_S,
                                           4)[2])
    print(f"[zoo] profiled 4 decode steps: {json.dumps(prof)}", flush=True)
    del last, cache
    del params
    # float32 weights and cache: the same comparison, tight
    params = dec.init_model(cfg, 0, torch.float32, dev)
    last, cache, t32 = dec.run_prefill(cfg, params, prompts, total,
                                       torch.float32)
    last_p, st_p = _plain_prefill(cfg, params, prompts, torch.float32)
    lg32, st32 = _rel(last[:, :v], last_p), _rel(cache["state"], st_p)
    print(f"[zoo] float32 kernel vs plain prefill (kernel prefill "
          f"{t32:.3f} s): last logits relative L2 {lg32:.4e}, final states "
          f"{st32:.4e}", flush=True)
    if not (lg32 <= ZOO_F32_REL and st32 <= ZOO_F32_REL):
        raise AssertionError(f"zoo float32: logits {lg32}, states {st32} > "
                             f"{ZOO_F32_REL}")
    return pre


def _leaf_rel(a, b) -> float:
    """max |a - b| over max |b| (0 where both are 0)."""
    den = float(b.double().abs().max())
    num = float((a.double() - b.double()).abs().max())
    return num / den if den else num


def _tree_rel(a, b) -> float:
    """The largest `_leaf_rel` over two trees' leaves (on any devices)."""
    from repro_torch.convert import leaves_with_paths
    return max(_leaf_rel(x.cpu(), y.cpu()) for (_, x), (_, y) in
               zip(leaves_with_paths(a), leaves_with_paths(b)))


def rwkv6_grad_check(dev):
    """The differentiable rwkv6 on the card: the gradients of r, k, v,
    logw, u and state0 through `ops.rwkv6` (its forward the kernel, one
    launch; its backward the plain chunked form with all chunks at once)
    against autograd through `ops.rwkv6_plain` (the chunk loop), at one
    full-width sequence (32 heads x 4096 tokens) and at a ragged S with
    a state. Returns the largest error."""
    import torch

    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(5)
    bh, d, worst = RWKV_H, RWKV_D, 0.0
    for s, with_state in ((TRAIN_S, False), (TRAIN_S - 3, True)):
        def draw(shape, scale):
            return torch.randn(shape, generator=g, device=dev) * scale

        r, k, v = (draw((bh, s, d), 0.5) for _ in range(3))
        lw = torch.clamp(-torch.exp(draw((bh, s, d), 0.3) - 1.0), -4.0,
                         -1e-4)
        leaves = [r, k, v, lw, draw((bh, d), 0.3)]
        if with_state:
            leaves.append(draw((bh, d, d), 0.3))
        leaves = [t.requires_grad_() for t in leaves]
        go, gs = draw((bh, s, d), 1.0), draw((bh, d, d), 1.0)

        def grads(fn):
            o, st = fn(*leaves, *([None] * (6 - len(leaves))))
            return torch.autograd.grad((o * go).sum() + (st * gs).sum(),
                                       leaves)

        _zero_counts()
        got = grads(ops.rwkv6)
        launched = _counts()["rwkv6"]
        want = grads(ops.rwkv6_plain)
        err = max(_leaf_rel(a, b) for a, b in zip(got, want))
        ms = _time_ms(lambda: grads(ops.rwkv6), iters=5, warmup=1)
        plain_ms = _time_ms(lambda: grads(ops.rwkv6_plain), iters=3,
                            warmup=1)
        print(f"[train] rwkv6 Function ({bh}, {s}, {d}) state0="
              f"{'yes' if with_state else 'no'}: {launched} kernel launch, "
              f"gradients of {len(leaves)} inputs vs autograd through the "
              f"plain chunk loop: max error {err:.3e} of each leaf's max "
              f"(tol {RWKV6_GRAD_REL}); forward + backward {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms", flush=True)
        if launched != 1 or not err <= RWKV6_GRAD_REL:
            raise AssertionError(f"rwkv6 Function S={s}: {launched} "
                                 f"launches, gradient error {err}")
        worst = max(worst, err)
    return worst


# The DT wide form's held shapes: the zoo's `dt` micro-batches (M = 8 at
# D = 1024-8192 as chip_smoke's steps run them, and the published M = 1,
# 2 and 16 of `pick_n_micro` at train_4k: kimi-k2, deepseek-67b and
# llama-3.2-vision at 1, gemma2-27b at 2, qwen2-0.5b and seamless at 16),
# the cohort form, M = 512 (the ranks split the keys) and 37 rows at D =
# 260 (two clusters of the D split) in the card tests.
DT_WIDE_SHAPES = ((8, 2048), (2, 8, 2048), (512, 2048), (8, 4608),
                  (8, 8192), (2, 8, 8192), (512, 8192), (8, 1600),
                  (512, 1600), (8, 1024), (512, 1024), (16, 896),
                  (16, 1024), (2, 4608), (1, 7168), (1, 8192),
                  (5, 8, 2048))


def dt_wide_check(dev):
    """The DT kernel's wide form (256 < D <= 8192) against
    `ref.dt_loss_fwd_ref` (the cohort form against
    `dt_loss_fwd_cohort_ref`) on unit rows at every DT_WIDE_SHAPES shape:
    one launch each and none of the narrow kernel, all four outputs within
    DT_FWD_TOL, two calls bitwise equal; D = 8196 and D = 8190 refused;
    its registers and spill bytes (0, or it fails). Device ms at every
    (M, D) shape against `_dt_bound` and two yardsticks that are not the
    same function: ``gram_ms``, the device time of the float32 product
    q @ k.T in cuBLAS (TF32 off), and ``floor_ms``, that of a one-element
    fill (a launch's floor). Card ms and the plain version at (8, 2048).
    Returns its kernels-line row."""
    import torch

    from repro_torch.kernels import dt_loss as dt_kernel
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(6)
    errs, d, at = [], TRAIN_D, {}
    m = TRAIN_DT[0]
    for shape in DT_WIDE_SHAPES:
        q, k = _unit_rows(g, dev, shape), _unit_rows(g, dev, shape)
        _zero_counts()
        got = ops.dt_loss_fwd(q, k, 0.1, 1.0)
        counts = (dt_kernel.LAUNCHES, dt_kernel.WIDE_LAUNCHES)
        plain = (ref.dt_loss_fwd_cohort_ref if q.dim() == 3
                 else ref.dt_loss_fwd_ref)(q, k, 0.1, 1.0)
        err = max(_max_err(a, b) for a, b in zip(got, plain))
        again = ops.dt_loss_fwd(q, k, 0.1, 1.0)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"[train] dt_loss wide {shape}: max abs err vs plain "
              f"{err:.3e} (tol {DT_FWD_TOL}), launches (narrow, wide) "
              f"{counts}, two calls bitwise equal: {same}", flush=True)
        if not (err <= DT_FWD_TOL and counts == (0, 1) and same):
            raise AssertionError(f"dt_loss wide {shape}: err {err}, "
                                 f"launches {counts}, bitwise {same}")
        errs.append(err)
        if len(shape) == 2:
            at[shape] = (_device_ms(lambda: ops.dt_loss_fwd(q, k, 0.1, 1.0),
                                    "dt_fwd_wide", iters=50),
                         _dt_bound(1, *shape),
                         _device_ms_all(lambda: q @ k.T, iters=50))
    for bad in (8196, 8190):
        x = _unit_rows(g, dev, (m, bad))
        try:
            ops.dt_loss_fwd(x, x, 0.1, 1.0)
        except ValueError:
            continue
        raise AssertionError(f"dt_loss wide: D = {bad} was not refused")
    one = torch.empty(1, device=dev)
    floor_ms = _device_ms_all(lambda: one.fill_(0.0), iters=200)
    attrs = dt_kernel.wide_kernel_attributes(d)
    print(f"[train] dt_loss wide: {attrs['regs']} registers and "
          f"{attrs['local_bytes']} local bytes a thread, "
          f"{attrs['shared_bytes']} shared bytes and {attrs['threads']} "
          f"threads a CTA, {attrs['blocks_per_sm']} CTAs an SM, clusters of "
          f"{attrs['cluster']} CTAs", flush=True)
    if attrs["local_bytes"] != 0:
        raise AssertionError(f"dt_loss wide spills: {attrs}")
    for (mm, dd), (t, (b, by), gram) in at.items():
        print(f"[train] dt_loss wide ({mm}, {dd}): device {t:.5f} ms, bound "
              f"{b:.5f} ms ({by}), {100 * b / t:.1f}% of it; gram (q @ k.T, "
              f"cuBLAS float32) {gram:.5f} ms; launch floor {floor_ms:.5f} "
              f"ms", flush=True)
    q, k = (_unit_rows(g, dev, (m, d)) for _ in range(2))
    ms = _time_ms(lambda: ops.dt_loss_fwd(q, k, 0.1, 1.0), iters=200)
    dev_ms = _device_ms(lambda: ops.dt_loss_fwd(q, k, 0.1, 1.0),
                        "dt_fwd_wide", iters=200)
    plain_ms = _time_ms(lambda: ref.dt_loss_fwd_ref(q, k, 0.1, 1.0),
                        iters=50)
    bound_ms, bound_by = _dt_bound(1, m, d)
    print(f"[train] dt_loss wide ({m}, {d}): kernel {ms:.4f} ms "
          f"(device {dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.5f} ms ({bound_by}); D = 8196 and 8190 refused",
          flush=True)
    row = {"name": "dt_loss_wide", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/dt_loss.cu",
           "replaces": "src/repro/kernels/dt_loss.py:33",
           "shape": [m, d], "max_abs_err": max(errs), "ms": ms,
           "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": None,
           "device_ms_512": at[(512, d)][0],
           "bound_ms_512": at[(512, d)][1][0], "floor_ms": floor_ms}
    for (mm, dd), (t, (b, _), gram) in at.items():
        row[f"device_ms_{mm}_{dd}"] = t
        row[f"bound_ms_{mm}_{dd}"] = b
        row[f"gram_ms_{mm}_{dd}"] = gram
    row.update({k: attrs[k] for k in ("regs", "local_bytes", "shared_bytes",
                                      "blocks_per_sm", "cluster")})
    return row


def _dt_kernel_spread(cfg, params, tokens, drops, aux_inputs=None) -> dict:
    """How far the DT kernel's float32 difference from the plain version
    may reach the DT step on this batch, by specification, with the
    kernel held to it on the card's features (raises otherwise):

    * ``amp``, the gradient's widening: the kernel's lse_a is held to
      DT_FWD_TOL of the plain version's, and the backward (`ops._DTLoss`)
      forms dL/dsim_ii from p_a(pos) - 1 = -w_a with the kernel's lse_a,
      w_a = 1 - p_a(pos) from the plain version. A row whose positive
      takes nearly all of the softmax at tau_a turns an error e in lse_a
      into a relative one e / w_a (the loss itself, w_b to first order,
      does not see it), so the gradient may move by DT_FWD_TOL / min(w_a).
    * ``loss_tol``, the mean loss's relative limit of DENSE's comment
      block at DT_EXP_ULPS: lse_b is held to DT_FWD_TOL as lse_a is, and
      the kernel's mean loss to ``loss_tol`` of the plain version's.

    Also returns the measured errors, min(w_a), and the plain version's
    float32 mean loss against its float64 evaluation on the same
    features (the formula's own rounding). `aux_inputs`: the ``audio``
    family's frames or the ``vlm`` family's patches, which both views
    read."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T

    with torch.no_grad():
        q, k = (T.forward_features(cfg, params, torch.where(
            d, steps.MASK_TOKEN, tokens), aux_inputs=aux_inputs)[0]
            for d in drops)
        loss_k, la_k, lb_k, _ = ops.dt_loss_fwd(q, k, 0.1, 1.0)
        loss_p, la_p, lb_p, pos = ref.dt_loss_fwd_ref(q, k, 0.1, 1.0)
        loss_64 = ref.dt_loss_from_sim(q.double() @ k.double().T, 0.1,
                                       1.0)[0]
    pos, la, lb, loss = (t.double() for t in (pos, la_p, lb_p, loss_p))
    w_a = 1.0 - torch.exp(pos / 0.1 - la)
    w_b = 1.0 - torch.exp(pos - lb)
    rho = (TRAIN_LOSS_REL + DT_FWD_TOL * (1.0 + (1.0 - w_b) / w_b)
           + DT_EXP_ULPS * 2.0 ** -24 / w_a)
    out = {"lse_a_err": float((la_k - la_p).abs().max()),
           "lse_b_err": float((lb_k - lb_p).abs().max()),
           "w_min": float(w_a.min()),
           "loss_tol": float((loss * rho).sum() / loss.sum()),
           "kernel_loss_rel": float(abs(loss_k.double().mean() - loss.mean())
                                    / loss.mean()),
           "f32_loss_rel": float(abs(loss.mean() - loss_64.mean())
                                 / loss_64.mean())}
    out["amp"] = DT_FWD_TOL / out["w_min"]
    if not (out["lse_a_err"] <= DT_FWD_TOL and out["lse_b_err"] <= DT_FWD_TOL
            and out["kernel_loss_rel"] <= out["loss_tol"]):
        raise AssertionError(f"dt_loss on the card's features: {out}, "
                             f"lse tol {DT_FWD_TOL}")
    return out


def _ctx_input(cfg, b: int, s: int):
    """(key, shape) of the context input of `b` sequences of `s` tokens:
    the ``audio`` family's frames (B, max(S // 4, 8), d_audio), the
    ``vlm`` family's patches (B, n_vision_tokens, d_vision); None for
    the other families."""
    from repro_torch.launch import steps

    if cfg.family == "audio":
        return "frames", steps.frames_shape(cfg, b, s)
    if cfg.family == "vlm":
        return "patches", steps.patches_shape(cfg, b)
    return None


def train_cross_check(dev, arch="rwkv6-1.6b", cases=(("lm", 2, 4, 37),
                                                      ("dt", 1, 4, 37)),
                      tag="[train]", dt_loss_spec=False, **replace):
    """``<arch>-smoke`` in float32: for each (objective, micro-batches,
    B, S) of `cases` (default: one ``lm`` step (flsimco, sgdm) in 2
    micro-batches and one ``dt`` step, B = 4, S = 37) the step from the
    same params and batch on the card and on the CPU: the loss (within
    TRAIN_LOSS_REL; with `dt_loss_spec` the ``dt`` loss within the
    batch's `_dt_kernel_spread` limit), every gradient leaf, and the
    params and momentum after the step. The ``dt`` leaves are held at
    TRAIN_LEAF_REL plus DT_FWD_TOL / min(w_a), the most the DT kernel's
    specified float32 difference in lse_a can reach the gradient
    (`_dt_kernel_spread`, which also holds the kernel's lse_a and lse_b
    to DT_FWD_TOL on the card's features). An ``audio`` or ``vlm``
    config gets CROSS_GATES (`_set_gates`) and each batch its context
    input (`_ctx_input`), standard normal. `replace`: fields of the smoke config to
    change (`dataclasses.replace`)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.convert import tree_map
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config(arch + "-smoke"), **replace)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    if cfg.family in ("audio", "vlm"):
        _set_gates(params)
    for objective, nm, b, s in cases:
        shape = InputShape("cross", s, b, "train")
        rs = np.random.RandomState(0)
        batch = {"tokens": torch.from_numpy(rs.randint(1, cfg.vocab_size,
                                                       (b, s))),
                 "blur": torch.from_numpy(rs.uniform(9.0, 25.0, b).astype(
                     np.float32)),
                 "drops": steps.draw_drop_masks(
                     (b, s), torch.Generator().manual_seed(1))}
        ctx_in = _ctx_input(cfg, b, s)
        if ctx_in is not None:
            batch[ctx_in[0]] = torch.from_numpy(
                rs.randn(*ctx_in[1]).astype(np.float32))
        outs = []
        for d in (dev, torch.device("cpu")):
            p = tree_map(lambda t: t.to(d), params)
            bt = {k: v.to(d) for k, v in batch.items()}
            loss, grads = steps.make_grad_fn(cfg, objective=objective,
                                             n_micro=nm)(p, bt)
            fn, _ = steps.make_train_step(cfg, shape, objective=objective,
                                          n_micro=nm)
            new_p, new_m, _ = fn(p, steps.init_momentum(p), bt)
            outs.append((float(loss), grads, new_p, new_m))
        (lc, gc, pc, mc), (lh, gh, ph, mh) = outs
        amp, loss_tol, note = 0.0, TRAIN_LOSS_REL, ")"
        if objective == "dt":
            sp = _dt_kernel_spread(
                cfg, tree_map(lambda t: t.to(dev), params),
                batch["tokens"].to(dev), batch["drops"].to(dev),
                {k: batch[k].to(dev) for k in steps.AUX_KEYS
                 if k in batch} or None)
            amp = sp["amp"]
            if dt_loss_spec:
                loss_tol = sp["loss_tol"]
            note = (f" = {TRAIN_LEAF_REL} + DT_FWD_TOL / min(w_a), min(w_a) "
                    f"{sp['w_min']:.3e}); on the card's features the DT "
                    f"kernel's lse_a within {sp['lse_a_err']:.2e} and lse_b "
                    f"within {sp['lse_b_err']:.2e} of the plain version's "
                    f"(tol {DT_FWD_TOL}), its loss within "
                    f"{sp['kernel_loss_rel']:.2e} (the specified limit "
                    f"{sp['loss_tol']:.2e}); the plain float32 loss against "
                    f"float64 {sp['f32_loss_rel']:.2e}")
        leaf_tol = TRAIN_LEAF_REL + amp
        loss_rel = abs(lc - lh) / abs(lh)
        grad_rel = max(_leaf_rel(a.cpu(), b_) for a, b_ in zip(gc, gh))
        tree_rel = max(_tree_rel(pc, ph), _tree_rel(mc, mh))
        print(f"{tag} {cfg.name} float32 {objective} step (B={b}, S={s}, "
              f"{nm} micro): card vs cpu loss {lc:.7f} vs {lh:.7f} "
              f"(relative {loss_rel:.2e}, tol {loss_tol:.2e}); gradient "
              f"leaves {grad_rel:.2e}, params and momentum after the step "
              f"{tree_rel:.2e} of each leaf's max (tol {leaf_tol:.2e}"
              + note, flush=True)
        if not (loss_rel <= loss_tol and grad_rel <= leaf_tol
                and tree_rel <= leaf_tol):
            raise AssertionError(f"{tag} {objective} card vs cpu: loss "
                                 f"{loss_rel}, grads {grad_rel}, trees "
                                 f"{tree_rel}, tol {leaf_tol}")


def _micro_norms(cfg, params, batch, eps=None):
    """The loss and the gradient norms (one a leaf) of an ``lm`` micro-
    batch: with the rwkv6 Function's forward on the kernel (`eps` None),
    or through the plain chunked version on the card, its outputs o
    scaled by (1 +- eps) with a seeded random sign when eps > 0."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import steps

    grad_fn = steps.make_grad_fn(cfg, objective="lm", aggregation="fedavg")
    if eps is None:
        loss, grads = grad_fn(params, batch)
        return [float(loss)] + [float(x.norm()) for x in grads]
    g = torch.Generator(device=batch["tokens"].device).manual_seed(321)

    def plain(*args):
        o, st = ops.rwkv6_plain(*args)
        if eps:
            sign = torch.randint(0, 2, o.shape, generator=g,
                                 device=o.device) * 2.0 - 1.0
            o = o * (1.0 + eps * sign)
        return o, st

    saved = ops._rwkv6_forward
    ops._rwkv6_forward = plain
    try:
        _zero_counts()
        loss, grads = grad_fn(params, batch)
        if _counts()["rwkv6"]:
            raise AssertionError("train: the plain micro-batch launched "
                                 "rwkv6")
    finally:
        ops._rwkv6_forward = saved
    return [float(loss)] + [float(x.norm()) for x in grads]


def _norms_rel(a, b) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b) if y)


def _train_run(cfg, params, objective, batch_, seq, n_micro, steps_, dev,
               ranges=(), tag="[train]", one_micro=False):
    """Full-width steps through `launch/train.py`'s functions: one
    warm-up step, then `steps_` timed steps with the counters zeroed just
    before and the peak memory reset; one more step under the profiler
    (with the device time of the record_function `ranges`). With
    `one_micro` the warm-up and the profiled step take one micro-batch
    (batch_ / n_micro sequences, the same shapes a micro-batch of the
    timed step has), so the profile holds an eighth of the events of an
    8-micro-batch step. `params` may be a function that makes them, so
    that no caller holds the first copy past the warm-up step, which
    replaces it. Returns (params, the timed steps' launches)."""
    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.launch import steps as st
    from repro_torch.launch import train as tr

    if callable(params):
        params = params()
    shape = InputShape(objective, seq, batch_, "train")
    fn, nm = st.make_train_step(cfg, shape, objective=objective,
                                n_micro=n_micro)
    mom = st.init_momentum(params)
    batches = [tr.make_batch(cfg, shape, i, 0, dev, objective)
               for i in range(steps_ + 2)]
    side_fn = fn
    if one_micro:
        part = InputShape(objective, seq, batch_ // nm, "train")
        side_fn, _ = st.make_train_step(cfg, part, objective=objective,
                                        n_micro=1)
        for i in (0, steps_ + 1):
            batches[i] = tr.make_batch(cfg, part, i, 0, dev, objective)
    t = time.time()
    params, mom, [(loss0, _)] = tr.run_steps(side_fn, params, mom,
                                             batches[:1], dev)
    warm = time.time() - t
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    params, mom, timed = tr.run_steps(fn, params, mom,
                                      batches[1:steps_ + 1], dev)
    counts = _counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    tokens = batch_ * seq
    secs = [t_ for _, t_ in timed]
    per = {k: v // steps_ for k, v in counts.items()}
    print(f"{tag} {cfg.name} {objective} bfloat16, {batch_} x {seq} "
          f"tokens a step in {nm} micro-batches: warm-up step "
          + ("(one micro-batch) " if one_micro else "")
          + f"{warm:.2f} s (loss {loss0:.4f}); {steps_} steps, seconds a "
          f"step "
          f"{[round(x, 4) for x in secs]}, {tokens * steps_ / sum(secs):.0f} "
          f"tok/s; losses {[round(l_, 5) for l_, _ in timed]}; peak memory "
          f"{peak:.2f} GiB; launches a step {per}", flush=True)
    want = {k: 0 for k in counts}
    if cfg.family == "ssm":    # one a layer and view; dense runs none
        want["rwkv6"] = cfg.n_layers * nm * (2 if objective == "dt" else 1)
    want["dt_loss_wide"] = nm if objective == "dt" else 0
    if per != want or any(v % steps_ for v in counts.values()):
        raise AssertionError(f"{tag} {objective} launches {counts} over "
                             f"{steps_} steps, want {want} a step")
    if not all(math.isfinite(l_) for l_, _ in timed + [(loss0, 0)]):
        raise AssertionError(f"{tag} {objective}: a loss is not finite")
    if not peak <= PEAK_GIB:
        raise AssertionError(f"{tag} {objective}: peak {peak:.2f} GiB > "
                             f"{PEAK_GIB}")

    def work():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        side_fn(params, mom, batches[-1])
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    prof = _profile(work, ranges=ranges)
    what = f"{cfg.name} {objective} step" + (
        f" (one micro-batch, {batch_ // nm} x {seq})" if one_micro else "")
    print(f"{tag} profiled {what}: {json.dumps(prof)}", flush=True)
    _range_shares(tag, what, prof, ranges)
    return params, counts


def _range_shares(tag, what, prof, ranges) -> None:
    """Prints each record_function range's device ms and its share of the
    profiled device busy time."""
    if ranges and prof["device_busy_ms"]:
        print(f"{tag} {what}: " + "; ".join(
            f"{name} {prof[f'{name}_ms']:.1f} ms of device time, "
            f"{prof[f'{name}_ms'] / prof['device_busy_ms']:.4f} of the "
            f"busy {prof['device_busy_ms']:.1f} ms" for name in ranges),
            flush=True)


def train_full_width(dev):
    """``rwkv6-1.6b`` at full width, random bfloat16 weights from seed 0,
    through `launch/train.py`: the ``lm`` objective (flsimco, sgdm) at
    TRAIN_LM and the ``dt`` objective at TRAIN_DT; the first ``lm``
    micro-batch's loss and gradient norms held against the plain rwkv6
    forward. Returns the timed steps' launches, both runs summed."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import decode as dec
    from repro_torch.launch import train as tr

    cfg = get_config("rwkv6-1.6b")
    torch.cuda.empty_cache()
    print(f"[train] full width: {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB allocated before the phase", flush=True)
    params = dec.init_model(cfg, 0, torch.bfloat16, dev)
    # the kernel in place: one lm micro-batch (one sequence), its loss
    # and gradient norms with the kernel, the plain version, and the
    # plain version perturbed by 2 float32 ULP (the floor)
    mb = tr.make_batch(cfg, InputShape("lm", TRAIN_S, 1, "train"), 0, 0,
                       dev, "lm")
    kern = _micro_norms(cfg, params, mb)
    plain = _micro_norms(cfg, params, mb, 0.0)
    floor = _micro_norms(cfg, params, mb, ZOO_ULP_EPS)
    k_rel, f_rel = _norms_rel(kern, plain), _norms_rel(floor, plain)
    print(f"[train] bfloat16 lm micro-batch (1 x {TRAIN_S}), kernel vs "
          f"plain forward: loss {kern[0]:.6f} vs {plain[0]:.6f}; loss and "
          f"{len(kern) - 1} gradient norms, largest relative difference "
          f"{k_rel:.4e} (2-ULP floor {f_rel:.4e}, held at "
          f"{ZOO_BF16_FLOOR_X} x)", flush=True)
    if not k_rel <= ZOO_BF16_FLOOR_X * f_rel:
        raise AssertionError(f"[train] kernel vs plain {k_rel} > "
                             f"{ZOO_BF16_FLOOR_X} x floor {f_rel}")
    b, s, nm = TRAIN_LM
    params, lm = _train_run(cfg, params, "lm", b, s, nm, TRAIN_LM_STEPS,
                            dev, ("rwkv6.recompute",))
    del params
    torch.cuda.empty_cache()
    params = dec.init_model(cfg, 0, torch.bfloat16, dev)
    b, s, nm = TRAIN_DT
    _, dt = _train_run(cfg, params, "dt", b, s, nm, TRAIN_DT_STEPS, dev,
                       ("rwkv6.recompute",))
    return _add(lm, dt)


def dense_cross_check(dev):
    """The dense smoke configs in float32 on the card and with
    ``device="cpu"`` from the same params: a prefill of DENSE_CROSS_S
    positions (past the smoke window of 32) then 4 decode steps, with the
    float32 cache (`launch.steps`' prefill and decode) and the int8 cache
    (`init_cache` and `forward`'s prefill, then the decode step; logits and the
    caches: positions bitwise, float32 k and v at ZOO_CROSS_TOL, int8
    codes within one step, logits then at DENSE_INT8_TOL); then one
    ``lm`` step in 2 micro-batches (S = FLASH_MIN_SQ for tinyllama, so
    the flash Function and its backward run) and one ``dt`` step,
    through `train_cross_check`."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.convert import tree_map
    from repro_torch.launch import steps
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cpu = torch.device("cpu")
    for arch in DENSE_SMOKE:
        cfg = get_config(arch + "-smoke")
        v, b, s, n = cfg.vocab_size, 2, DENSE_CROSS_S, 4
        params = T.init_params(cfg, torch.Generator().manual_seed(0))
        toks = torch.from_numpy(np.random.RandomState(0).randint(
            1, v, (b, s + n)))
        shape = InputShape("cross", s + n, b, "prefill")
        for cdt in (torch.float32, torch.int8):
            outs = []
            for d in (dev, cpu):
                p = tree_map(lambda t: t.to(d), params)
                tk = toks.to(d)
                if cdt == torch.float32:
                    last, cache = steps.make_prefill_step(
                        cfg, shape, torch.float32)(p, {"tokens": tk[:, :s]})
                else:
                    with torch.no_grad():
                        lg, cache, _ = T.forward(
                            cfg, p, tk[:, :s], mode="prefill",
                            cache=T.init_cache(cfg, b, s + n, dtype=cdt,
                                               device=d))
                    last = lg[:, -1]
                logits = [last]
                decode = steps.make_decode_step(cfg, shape)
                for i in range(n):
                    lg, cache = decode(p, {
                        "tokens": tk[:, s + i:s + i + 1], "cache": cache,
                        "positions": torch.full((b,), s + i, device=d)})
                    logits.append(lg)
                outs.append(([t[:, :v].cpu() for t in logits],
                             {k: c.cpu() for k, c in cache["kv"].items()}))
            (lc, cc), (lh, ch) = outs
            err = max(_max_err(a, c) for a, c in zip(lc, lh))
            if not torch.equal(cc["pos"], ch["pos"]):
                raise AssertionError(f"[dense] {arch} cache positions differ")
            if cdt == torch.int8:
                cache_err = max(int((cc[k].int() - ch[k].int()).abs().max())
                                for k in ("k", "v"))
                ok = cache_err <= 1 and err <= DENSE_INT8_TOL
            else:
                cache_err = max(_max_err(cc[k], ch[k]) for k in ("k", "v"))
                ok = cache_err <= ZOO_CROSS_TOL and err <= ZOO_CROSS_TOL
            print(f"[dense] {cfg.name} {str(cdt)[6:]} cache, prefill {b}x{s} "
                  f"+ {n} decode steps: card vs cpu logits max abs "
                  f"{err:.3e}, cache k/v {cache_err:.3e}"
                  + (" (codes)" if cdt == torch.int8 else ""), flush=True)
            if not ok:
                raise AssertionError(f"[dense] {arch} {cdt}: logits {err}, "
                                     f"cache {cache_err}")
        lm_s = L.FLASH_MIN_SQ if arch == DENSE_SMOKE[0] else s
        train_cross_check(dev, arch, (("lm", 2, 2, lm_s), ("dt", 1, 4, s)),
                          tag="[dense]", dt_loss_spec=True)


def _dense_logits(cfg, params, tokens, start: int, eps: float = 0.0,
                  aux_inputs=None):
    """Float32 logits over the real vocabulary of positions start.. of a
    full forward (train mode, no cache) of `tokens` (with `aux_inputs`,
    the ``audio`` family's frames or the ``vlm`` family's patches), the
    head on those positions only;
    with eps > 0 every attention output is scaled by (1 +- eps), a
    seeded random sign an element, and rounded back to its dtype."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    g = torch.Generator(device=tokens.device).manual_seed(77)
    core = L.attention_core

    def perturbed(*args, **kw):
        o = core(*args, **kw)
        sign = torch.randint(0, 2, o.shape, generator=g,
                             device=o.device) * 2.0 - 1.0
        return (o.float() * (1.0 + eps * sign)).to(o.dtype)

    if eps:
        L.attention_core = perturbed
    try:
        with torch.no_grad():
            x, _, _ = T._forward_hidden(cfg, params, tokens,
                                        mode="train", cache=None,
                                        aux_inputs=aux_inputs)
            return T._head(cfg, params, x[:, start:])[..., :cfg.vocab_size]
    finally:
        L.attention_core = core


def _serve_run(dev, cfg, batch: int, prompt: int, n_dec: int, tag: str,
               flash: bool = True, aux=None, prepare=None):
    """A zoo model with random bfloat16 weights from seed 0 (passed to
    `prepare` first, when given) through launch/decode.py's functions:
    `batch` prompts of `prompt` tokens (with `aux`, the context inputs
    of `run_prefill`: the ``audio`` family's ``{"frames"}``, the ``vlm``
    family's ``{"patches"}``) prefilled (`flash`: on the flash path; else within the
    ring, prompt <= its width) into a bfloat16 cache of `prompt` +
    `n_dec` slots (of the window's width where that is less), then
    `n_dec` greedy decode steps, timed after a
    warm-up, the counters zeroed before each; no kernel launch (the
    attention families' serving path runs none) and peak memory at most
    PEAK_GIB. Prints the times; returns a namespace of params, prompts,
    aux, the timed prefill's last logits and cache, the decoded
    tokens and the launches."""
    import types

    import torch

    from repro_torch.convert import leaves_with_paths
    from repro_torch.launch import decode as dec
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    bf16 = torch.bfloat16
    total = prompt + n_dec
    if flash and (prompt < L.FLASH_MIN_SQ or total % L.FLASH_CHUNK):
        raise AssertionError(f"{tag} {cfg.name}: {prompt} + {n_dec} does "
                             f"not prefill on the flash path")
    if not flash and prompt > T.cache_width(cfg, total, False):
        raise AssertionError(f"{tag} {cfg.name}: a {prompt}-token prompt "
                             f"overflows the ring")
    t = time.time()
    params = dec.init_model(cfg, 0, bf16, dev)
    if prepare is not None:
        prepare(params)
    prompts = dec.random_prompts(cfg, batch, prompt, 0, dev)
    aux = aux or {}
    last, cache, t_warm = dec.run_prefill(cfg, params, prompts, total, bf16,
                                          **aux)
    dec.run_decode(cfg, params, last, cache, prompt, 2)
    del last, cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warm = time.time() - t
    _zero_counts()
    last, cache, t_pre = dec.run_prefill(cfg, params, prompts, total, bf16,
                                         **aux)
    pre = _counts()
    _zero_counts()
    toks, _, t_dec = dec.run_decode(cfg, params, last, cache, prompt, n_dec)
    dcd = _counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(x.numel() for _, x in leaves_with_paths(params))
    print(f"{tag} {cfg.name} ({cfg.n_layers} layers, {n_params:,} "
          f"parameters, bfloat16): set-up and warm-up {warm:.2f} s (first "
          f"prefill {t_warm:.3f} s); prefill {batch}x{prompt} into {total} "
          f"slots: {t_pre:.4f} s ({batch * prompt / t_pre:.0f} tok/s); "
          f"{n_dec} decode steps x {batch}: {t_dec:.4f} s, "
          f"{t_dec * 1e3 / n_dec:.3f} ms per step, "
          f"{n_dec * batch / t_dec:.1f} tok/s; peak memory {peak:.2f} GiB; "
          f"launches prefill {pre}, decode {dcd}", flush=True)
    if any(pre.values()) or any(dcd.values()):
        raise AssertionError(f"{tag} launches: prefill {pre}, decode {dcd} "
                             f"(the serving path runs no kernel)")
    if not peak <= PEAK_GIB:
        raise AssertionError(f"{tag} {cfg.name}: peak {peak:.2f} GiB > "
                             f"{PEAK_GIB}")
    return types.SimpleNamespace(params=params, prompts=prompts,
                                 aux=aux, last=last, cache=cache,
                                 toks=toks, total=total,
                                 launches=_add(pre, dcd))


def _served_logits(cfg, params, last, cache, toks, start: int):
    """(B, n + 1, vocab) float32: the prefill's `last` logits and those of
    each decode step from `cache`, fed the decoded `toks` (B, n + 1) at
    positions start, start + 1, .."""
    import torch

    from repro_torch.launch import steps

    v, b, n = cfg.vocab_size, toks.shape[0], toks.shape[1] - 1
    decode = steps.make_decode_step(cfg)
    served, c = [last[:, :v]], cache
    for i in range(n):
        lg, c = decode(params, {"tokens": toks[:, i:i + 1], "cache": c,
                                "positions": torch.full(
                                    (b,), start + i, device=toks.device)})
        served.append(lg[:, :v])
    return torch.stack(served, 1)


def _decode_vs_full(tag, cfg, params, prompts, last, cache, toks,
                    note: str = "", aux=None) -> None:
    """Each decode step's logits (and the prefill's last) against a full
    forward of the prompts and the decoded tokens at the same positions
    (with the prefill's context inputs `aux`, for the ``audio`` and
    ``vlm`` families), held at
    DENSE_FLOOR_X times the divergence of that forward from itself with
    its attention outputs perturbed by DENSE_BF16_EPS (up to one
    bfloat16 step: the decode steps' direct path rounds its
    probabilities to bfloat16, the forward's flash path does not),
    measured in the same run."""
    import torch

    aux = aux or None
    prompt, n = prompts.shape[1], toks.shape[1] - 1
    served = _served_logits(cfg, params, last, cache, toks, prompt)
    seq = torch.cat([prompts, toks[:, :n]], 1)
    full = _dense_logits(cfg, params, seq, prompt - 1, aux_inputs=aux)
    floor = _rel(_dense_logits(cfg, params, seq, prompt - 1,
                               DENSE_BF16_EPS, aux), full)
    rel = _rel(served, full)
    agree = float((served.argmax(-1) == full.argmax(-1)).float().mean())
    finite = bool(torch.isfinite(served).all()) and bool(
        ((toks >= 0) & (toks < cfg.vocab_size)).all())
    print(f"{tag} {cfg.name} decode{note} vs a full forward at the same "
          f"{n + 1} positions: logits relative L2 {rel:.4e} (floor "
          f"{floor:.4e}: one bfloat16 step, held at {DENSE_FLOOR_X} x); "
          f"greedy picks equal {agree:.4f}", flush=True)
    if not (finite and rel <= DENSE_FLOOR_X * floor):
        raise AssertionError(f"{tag} {cfg.name}: decode vs full {rel} > "
                             f"{DENSE_FLOOR_X} x floor {floor}, finite "
                             f"{finite}")


def _serve_profiles(tag, cfg, run, ranges=()) -> None:
    """The prefill and 4 decode steps of `run` (a `_serve_run`) under the
    profiler, with the device time of the record_function `ranges`."""
    import torch

    from repro_torch.launch import decode as dec

    prof = _profile(lambda: dec.run_prefill(cfg, run.params, run.prompts,
                                            run.total, torch.bfloat16,
                                            **run.aux)[2],
                    ranges=ranges)
    print(f"{tag} profiled {cfg.name} prefill: {json.dumps(prof)}",
          flush=True)
    _range_shares(tag, f"{cfg.name} prefill", prof, ranges)
    prof = _profile(lambda: dec.run_decode(cfg, run.params, run.last,
                                           run.cache, run.prompts.shape[1],
                                           4)[2], ranges=ranges)
    print(f"{tag} profiled {cfg.name} 4 decode steps: {json.dumps(prof)}",
          flush=True)
    _range_shares(tag, f"{cfg.name} 4 decode steps", prof, ranges)
    print(f"{tag} {cfg.name} decode: {prof['kernel_launches'] / 4:.0f} "
          f"kernel launches a step, device idle {prof['idle_share']:.4f} of "
          f"the profiled steps", flush=True)


def dense_serve(dev, cfg, batch: int, prompt: int, n_dec: int) -> dict:
    """A dense model served by `_serve_run`, its decode held against a
    full forward (`_decode_vs_full`), its prefill and 4 decode steps
    profiled. Returns the launches of the prefill and the decode."""
    run = _serve_run(dev, cfg, batch, prompt, n_dec, "[dense]")
    _decode_vs_full("[dense]", cfg, run.params, run.prompts, run.last,
                    run.cache, run.toks)
    _serve_profiles("[dense]", cfg, run)
    return run.launches


def dense_full_width(dev) -> dict:
    """tinyllama-1.1b and qwen2-0.5b at full width: serving
    (`dense_serve` at DENSE_SERVE), then tinyllama's train steps through
    `launch/train.py` (``lm``, flsimco, sgdm at DENSE_LM; ``dt`` at
    DENSE_DT, the DT kernel's wide form at D = 2048). gemma2-27b and
    deepseek-67b at every published width with n_layers cut to
    DENSE_CUT_LAYERS (gemma2: one local and one global layer): serving at
    DENSE_CUT (a prefill past gemma2's 4096 window) and one ``dt`` step
    at DENSE_DT (the wide form at D = 4608 and 8192). Returns the
    launches of the timed steps and the serving runs."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import decode as dec

    total = {}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    for arch in DENSE_FULL:
        total = _add(total, dense_serve(dev, get_config(arch), *DENSE_SERVE))
        free()
    cfg = get_config(DENSE_FULL[0])
    for objective, (b, s, nm), n in (("lm", DENSE_LM, DENSE_LM_STEPS),
                                     ("dt", DENSE_DT, DENSE_DT_STEPS)):
        params = dec.init_model(cfg, 0, torch.bfloat16, dev)
        _, counts = _train_run(cfg, params, objective, b, s, nm, n, dev,
                               tag="[dense]")
        total = _add(total, counts)
        del params
        free()
    for arch in DENSE_CUT_ARCHS:
        cfg = dataclasses.replace(get_config(arch),
                                  n_layers=DENSE_CUT_LAYERS)
        total = _add(total, dense_serve(dev, cfg, *DENSE_CUT))
        free()
        b, s, nm = DENSE_DT
        params = dec.init_model(cfg, 0, torch.bfloat16, dev)
        _, counts = _train_run(cfg, params, "dt", b, s, nm, 1, dev,
                               tag="[dense]")
        total = _add(total, counts)
        del params
        free()
    return total


@contextlib.contextmanager
def _recorded_routes(store: list):
    """Every `layers.moe_slots` call in the block appends (idx (T, k),
    keep (T, k) bool, in token order) to `store`, as device tensors (no
    host sync)."""
    from repro_torch.models import layers as L

    slots = L.moe_slots

    def recording(cfg, idx, c):
        order, slot_e, slot_c, valid = slots(cfg, idx, c)
        keep = valid.new_zeros(valid.shape).index_put((order,), valid)
        store.append((idx, keep.reshape(idx.shape)))
        return order, slot_e, slot_c, valid

    L.moe_slots = recording
    try:
        yield store
    finally:
        L.moe_slots = slots


def _drops(routes) -> tuple:
    """(dropped assignments, assignments) over recorded routes."""
    import torch

    if not routes:
        return 0, 0
    dropped = torch.stack([(~keep).sum() for _, keep in routes]).sum()
    return int(dropped), sum(keep.numel() for _, keep in routes)


def moe_cross_check(dev):
    """The MoE smoke configs in float32 on the card and with
    ``device="cpu"`` from the same params: a prefill of DENSE_CROSS_S
    positions then 4 decode steps through `T.forward` (olmoe: MoE layers
    only; kimi: its dense first layer, the shared expert), logits, aux
    losses and every cache leaf at ZOO_CROSS_TOL, positions bitwise, and
    every MoE call's top-k indices and drop mask equal; then olmoe's
    ``lm`` step in 2 micro-batches through `train_cross_check`."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import tree_map
    from repro_torch.models import transformer as T

    cpu = torch.device("cpu")
    for arch in MOE_ARCHS:
        cfg = get_config(arch + "-smoke")
        v, b, s, n = cfg.vocab_size, 2, DENSE_CROSS_S, 4
        params = T.init_params(cfg, torch.Generator().manual_seed(0))
        toks = torch.from_numpy(np.random.RandomState(0).randint(
            1, v, (b, s + n)))
        outs = []
        for d in (dev, cpu):
            p = tree_map(lambda t: t.to(d), params)
            tk = toks.to(d)
            with _recorded_routes([]) as routes, torch.no_grad():
                lg, cache, aux = T.forward(
                    cfg, p, tk[:, :s], mode="prefill",
                    cache=T.init_cache(cfg, b, s + n, dtype=torch.float32,
                                       device=d))
                logits, auxes = [lg[:, -1]], [aux]
                for i in range(n):
                    lg, cache, aux = T.forward(
                        cfg, p, tk[:, s + i:s + i + 1], mode="decode",
                        cache=cache,
                        positions=torch.full((b,), s + i, device=d))
                    logits.append(lg[:, 0])
                    auxes.append(aux)
            outs.append(([t[:, :v].cpu() for t in logits],
                         torch.stack(auxes).cpu(),
                         tree_map(lambda t: t.cpu(), cache),
                         [(i.cpu(), k.cpu()) for i, k in routes]))
        (lc, ac, cc, rc), (lh, ah, ch, rh) = outs
        err = max(_max_err(a, c) for a, c in zip(lc, lh))
        aux_err = _max_err(ac, ah)
        cache_err = max(_max_err(cc[key][name], ch[key][name])
                        for key in ch for name in ("k", "v"))
        same_pos = all(torch.equal(cc[key]["pos"], ch[key]["pos"])
                       for key in ch)
        flips = sum(int((a.sort(-1).values != c.sort(-1).values).any(-1)
                        .sum()) for (a, _), (c, _) in zip(rc, rh))
        same_routes = len(rc) == len(rh) and all(
            torch.equal(a, c) and torch.equal(ka, kc)
            for (a, ka), (c, kc) in zip(rc, rh))
        dropped, assigned = _drops(rh)
        print(f"[moe] {cfg.name} float32, prefill {b}x{s} + {n} decode "
              f"steps: card vs cpu logits max abs {err:.3e}, aux {aux_err:.3e} "
              f"(aux {float(ah[0]):.6f} at the prefill), cache k/v "
              f"{cache_err:.3e} over {sorted(ch)}; {len(rh)} MoE calls, "
              f"routing equal {same_routes} ({flips} tokens' top-k sets "
              f"differ), {dropped} of {assigned} assignments dropped",
              flush=True)
        if not (err <= ZOO_CROSS_TOL and aux_err <= ZOO_CROSS_TOL
                and cache_err <= ZOO_CROSS_TOL and same_pos
                and same_routes):
            raise AssertionError(f"[moe] {arch}: logits {err}, aux "
                                 f"{aux_err}, cache {cache_err}, positions "
                                 f"{same_pos}, routing {same_routes}")
    train_cross_check(dev, MOE_ARCHS[0], (("lm", 2, 2, DENSE_CROSS_S),),
                      tag="[moe]")


def _flips(cfg, x, router, logits, idx_card, idx_cpu) -> tuple:
    """Tokens whose top-k sets differ between the card (`idx_card`) and
    the CPU (`idx_cpu`, from the CPU's float32 `logits` of the CPU
    tensors `x` and `router`), and whether each lies within the bound of
    the MoE comment block. Returns (flipped (T,) bool, the largest
    gap / bound over them (0 without), tokens within their bound)."""
    k, d = cfg.n_experts_active, x.shape[-1]
    flipped = (idx_card.sort(-1).values != idx_cpu.sort(-1).values).any(-1)
    top = logits.double().sort(-1, descending=True).values
    gap = top[:, k - 1] - top[:, k]
    u = 2.0 ** -24
    gamma = d * u / (1 - d * u)
    s_abs = x.double().abs() @ router.double().abs()
    bound = (4 * gamma * s_abs.max(-1).values
             + 16 * u * (1 + top[:, 0] - top[:, k]))
    ratio = gap[flipped] / bound[flipped]
    worst = float(ratio.max()) if bool(flipped.any()) else 0.0
    return flipped, worst, int((gap <= bound).sum())


def moe_block_check(dev):
    """One olmoe-1b-7b MoE layer at full width (64 experts, top-8, d 2048,
    d_ff 1024) in float32 with TF32 off, random weights and inputs drawn
    on the card and copied to the CPU: the routing of MOE_SERVE's 16 x
    3008 tokens card vs CPU (top-k sets, flips only within the bound of
    the MoE comment block, the drops of each side), then `moe_block` on
    MOE_OUT_T of them: the same flip rule, the outputs of the rows whose
    routing and drops agree, and the aux loss, at ZOO_CROSS_TOL; without
    a flip every row's drops agree."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import tree_map
    from repro_torch.models import layers as L

    cfg = get_config(MOE_ARCHS[0])
    k = cfg.n_experts_active
    g = torch.Generator(device=dev).manual_seed(0)
    p = L.init_moe(cfg, g)
    p_cpu = tree_map(lambda t: t.cpu(), p)
    t = MOE_SERVE[0] * MOE_SERVE[1]
    x = torch.randn((t, cfg.d_model), generator=g, device=dev)
    x_cpu = x.cpu()
    c = L.moe_capacity(cfg, t)
    routes = []
    t0 = time.perf_counter()
    for xd, router in ((x, p["router"]), (x_cpu, p_cpu["router"])):
        logits = xd @ router
        _, _, idx = L.moe_route(cfg, logits)
        _, _, _, valid = L.moe_slots(cfg, idx, c)
        routes.append((logits.cpu(), idx.cpu(), int((~valid).sum())))
    t_route = time.perf_counter() - t0
    (_, ic, dc), (lh, ih, dh) = routes
    flipped, worst, within = _flips(cfg, x_cpu, p_cpu["router"], lh, ic, ih)
    n_flip = int(flipped.sum())
    print(f"[moe] {cfg.name} router at full width, {t:,} tokens x "
          f"{cfg.n_experts} experts, float32: card vs cpu top-{k} sets "
          f"differ on {n_flip} tokens, their CPU k-th/(k+1)-th logit gaps "
          f"at most {worst:.3e} of their float32 bound ({within:,} tokens "
          f"lie within theirs); capacity {c}, dropped assignments card "
          f"{dc:,} and cpu {dh:,} of {t * k:,} (both routes {t_route:.2f} "
          f"s)", flush=True)
    if worst > 1.0:
        raise AssertionError(f"[moe] routing flips outside the float32 "
                             f"bound: worst gap / bound {worst}")
    xo, xo_cpu = x[:MOE_OUT_T], x_cpu[:MOE_OUT_T]
    outs = []
    for xd, pd in ((xo, p), (xo_cpu, p_cpu)):
        with _recorded_routes([]) as rec, torch.no_grad():
            y, aux = L.moe_block(cfg, pd, xd[None])
        outs.append((rec[0][0].cpu(), rec[0][1].cpu(), y[0].cpu(),
                     aux.cpu()))
    (ia, ka, ya, aa), (ib, kb, yb, ab) = outs
    flipped, worst, _ = _flips(cfg, xo_cpu, p_cpu["router"],
                               xo_cpu @ p_cpu["router"], ia, ib)
    rows = (ia == ib).all(-1) & (ka == kb).all(-1)
    err = _max_err(ya[rows], yb[rows])
    aux_err = _max_err(aa, ab)
    print(f"[moe] moe_block at full width on {MOE_OUT_T} tokens (capacity "
          f"{L.moe_capacity(cfg, MOE_OUT_T)}): {int(flipped.sum())} top-{k} "
          f"sets differ (worst gap / bound {worst:.3e}); card vs cpu "
          f"outputs max abs {err:.3e} over the {int(rows.sum())} rows whose "
          f"routing and drops agree, aux {aux_err:.3e} (tol "
          f"{ZOO_CROSS_TOL})", flush=True)
    if not (worst <= 1.0 and err <= ZOO_CROSS_TOL
            and aux_err <= ZOO_CROSS_TOL
            and (bool(flipped.any()) or bool(rows.all()))):
        raise AssertionError(f"[moe] moe_block card vs cpu: outputs {err}, "
                             f"aux {aux_err}, rows {int(rows.sum())}, flips "
                             f"{int(flipped.sum())} (worst {worst})")


def moe_serve(dev, cfg, batch: int, prompt: int, n_dec: int,
              check_b: int = 0) -> dict:
    """A MoE model served by `_serve_run`; then the prefill and the
    decode steps once more with the routes recorded (the dropped
    assignments at the published capacity factor), one decode step under
    `no_implicit_transfers` (no host sync), and, with `check_b`, the
    decode of `check_b` of the prompts at capacity factor E / k (C = T:
    nothing drops) held against a full forward (`_decode_vs_full`). The
    prefill and 4 decode steps profiled. Returns the launches."""
    import dataclasses

    import torch

    from repro_torch.analysis.guards import no_implicit_transfers
    from repro_torch.launch import decode as dec
    from repro_torch.launch import steps
    from repro_torch.models import layers as L

    bf16 = torch.bfloat16
    run = _serve_run(dev, cfg, batch, prompt, n_dec, "[moe]")
    with _recorded_routes([]) as rec:
        dec.run_prefill(cfg, run.params, run.prompts, run.total, bf16)
    pre_drop, pre_n = _drops(rec)
    with _recorded_routes([]) as rec:
        _served_logits(cfg, run.params, run.last, run.cache, run.toks,
                       prompt)
    dec_drop, dec_n = _drops(rec)
    torch.cuda.synchronize()
    with no_implicit_transfers():
        lg, _ = steps.make_decode_step(cfg)(run.params, {
            "tokens": run.toks[:, :1], "cache": run.cache,
            "positions": torch.full((batch,), prompt, device=dev)})
    torch.cuda.synchronize()
    print(f"[moe] {cfg.name} dropped assignments at capacity factor "
          f"{cfg.moe_capacity_factor}: prefill {pre_drop:,} of {pre_n:,} "
          f"(capacity {L.moe_capacity(cfg, batch * prompt)} of "
          f"{batch * prompt} tokens), decode {dec_drop / n_dec:.2f} a step "
          f"of {dec_n // n_dec} (capacity {L.moe_capacity(cfg, batch)} of "
          f"{batch} tokens); a decode step under no_implicit_transfers ran "
          f"with no host sync", flush=True)
    if not bool(torch.isfinite(lg[:, :cfg.vocab_size]).all()):
        raise AssertionError(f"[moe] {cfg.name}: guarded decode logits are "
                             f"not finite")
    del lg
    if check_b:
        nd = dataclasses.replace(
            cfg, moe_capacity_factor=cfg.n_experts / cfg.n_experts_active)
        sub = run.prompts[:check_b]
        last, cache, _ = dec.run_prefill(nd, run.params, sub, run.total,
                                         bf16)
        toks, _, _ = dec.run_decode(nd, run.params, last, cache, prompt,
                                    n_dec)
        with _recorded_routes([]) as rec:
            _decode_vs_full("[moe]", nd, run.params, sub, last, cache, toks,
                            note=f" of {check_b} sequences at capacity "
                                 f"factor {nd.moe_capacity_factor} (C = T)")
        dropped, _ = _drops(rec)
        if dropped:
            raise AssertionError(f"[moe] {cfg.name}: {dropped} assignments "
                                 f"dropped at capacity factor "
                                 f"{nd.moe_capacity_factor}")
        del last, cache
    _serve_profiles("[moe]", cfg, run)
    return run.launches


def moe_full_width(dev) -> dict:
    """olmoe-1b-7b at full width served (`moe_serve` at MOE_SERVE with the
    decode check on MOE_CHECK_B sequences), its train steps with n_layers
    cut to MOE_TRAIN_LAYERS (``lm`` at MOE_LM, ``dt`` at MOE_DT: the DT
    kernel's wide form at D = 2048, one launch), then kimi-k2-1t-a32b at
    every published width with n_layers cut to MOE_CUT_LAYERS, served at
    MOE_CUT. Prints each cut with its reason. Returns the launches of the
    timed steps and the serving runs."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import decode as dec

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    free()
    print(f"[moe] full width: {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB allocated before the phase", flush=True)
    olmoe = get_config(MOE_ARCHS[0])
    b, p_len, n_dec = MOE_SERVE
    print(f"[moe] cuts: {olmoe.name} served at full depth, {b} prompts x "
          f"{p_len} tokens + {n_dec} decode steps (prefill_32k's 32 x "
          f"32,768 and decode_32k's 128 sequences cut to one card's run; "
          f"3008 + 64 = 3072 slots puts the prefill on the flash path); "
          f"trained with n_layers {olmoe.n_layers} -> {MOE_TRAIN_LAYERS} "
          f"(bf16 params and momentum, float32 accumulators and bf16 "
          f"gradients of 6.9e9 parameters would take about 69 GB), batch "
          f"train_4k's 256 -> {MOE_LM[0]} x {MOE_LM[1]} in {MOE_LM[2]} "
          f"micro-batches, dt at {MOE_DT[0]} x {MOE_DT[1]}; "
          f"{MOE_CUT_ARCH} at every published width with n_layers 61 -> "
          f"{MOE_CUT_LAYERS} (its dense first layer and one MoE layer, 39 "
          f"GB of bf16 weights; a second MoE layer adds 33.8 GB), "
          f"{MOE_CUT[0]} prompts x {MOE_CUT[1]} + {MOE_CUT[2]} decode "
          f"steps, serving only", flush=True)
    total = moe_serve(dev, olmoe, *MOE_SERVE, check_b=MOE_CHECK_B)
    free()
    cfg = dataclasses.replace(olmoe, n_layers=MOE_TRAIN_LAYERS)
    for objective, (b, s, nm), n in (("lm", MOE_LM, MOE_LM_STEPS),
                                     ("dt", MOE_DT, MOE_DT_STEPS)):
        params = dec.init_model(cfg, 0, torch.bfloat16, dev)
        _, counts = _train_run(cfg, params, objective, b, s, nm, n, dev,
                               tag="[moe]")
        total = _add(total, counts)
        del params
        free()
    cfg = dataclasses.replace(get_config(MOE_CUT_ARCH),
                              n_layers=MOE_CUT_LAYERS)
    total = _add(total, moe_serve(dev, cfg, *MOE_CUT))
    free()
    return total


def hybrid_cross_check(dev):
    """``hymba-1.5b-smoke`` in float32 on the card and with
    ``device="cpu"`` from the same params: a train-mode forward of 36
    positions, then a prefill of 32 (its window: the ring filled) and 4
    decode steps through `T.forward`, the ring wrapping; logits and every
    cache leaf (k and v, the SSM and conv states) at ZOO_CROSS_TOL,
    positions bitwise; then an ``lm`` step in 2 micro-batches at S = 160
    (the SSM's 128 + 32 split, the recomputing backward over both parts)
    and a ``dt`` step through `train_cross_check`."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import tree_map
    from repro_torch.models import transformer as T

    cpu = torch.device("cpu")
    cfg = get_config(HYBRID_ARCH + "-smoke")
    v, b, s, n = cfg.vocab_size, 2, cfg.sliding_window, 4
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        1, v, (b, s + n)))
    outs = []
    for d in (dev, cpu):
        p = tree_map(lambda t: t.to(d), params)
        tk = toks.to(d)
        with torch.no_grad():
            full, _, _ = T.forward(cfg, p, tk)
            lg, cache, _ = T.forward(
                cfg, p, tk[:, :s], mode="prefill",
                cache=T.init_cache(cfg, b, s + n, dtype=torch.float32,
                                   device=d))
            logits = [lg[:, -1]]
            for i in range(n):
                lg, cache, _ = T.forward(
                    cfg, p, tk[:, s + i:s + i + 1], mode="decode",
                    cache=cache, positions=torch.full((b,), s + i, device=d))
                logits.append(lg[:, 0])
        outs.append((full[..., :v].cpu(), [t[:, :v].cpu() for t in logits],
                     tree_map(lambda t: t.cpu(), cache)))
    (fc, lc, cc), (fh, lh, ch) = outs
    full_err = _max_err(fc, fh)
    err = max(_max_err(a, c) for a, c in zip(lc, lh))
    cache_err = max([_max_err(cc["kv"][k], ch["kv"][k]) for k in ("k", "v")]
                    + [_max_err(cc[k], ch[k]) for k in ("ssm", "conv")])
    same_pos = torch.equal(cc["kv"]["pos"], ch["kv"]["pos"])
    print(f"[hybrid] {cfg.name} float32, forward {b}x{s + n}, prefill "
          f"{b}x{s} into {cc['kv']['k'].shape[2]} slots + {n} decode steps: "
          f"card vs cpu forward logits max abs {full_err:.3e}, prefill and "
          f"decode logits {err:.3e}, cache leaves (k, v, ssm, conv) "
          f"{cache_err:.3e}, positions equal {same_pos} (tol "
          f"{ZOO_CROSS_TOL})", flush=True)
    if not (full_err <= ZOO_CROSS_TOL and err <= ZOO_CROSS_TOL
            and cache_err <= ZOO_CROSS_TOL and same_pos):
        raise AssertionError(f"[hybrid] smoke card vs cpu: forward "
                             f"{full_err}, logits {err}, cache {cache_err}, "
                             f"positions {same_pos}")
    train_cross_check(dev, HYBRID_ARCH, (("lm", 2, 2, 160), ("dt", 1, 4, 37)),
                      tag="[hybrid]", dt_loss_spec=True)


def hybrid_ssm_check(dev):
    """One hymba-1.5b SSM layer at full width in float32 (TF32 off),
    weights and inputs drawn on the card and copied to the CPU: HYBRID_SSM_S
    tokens of 2 sequences from given SSM and conv states, the output and
    both new states at ZOO_CROSS_TOL; the gradients of a random
    projection of all three through the recomputing backward, of every
    leaf, the input and the starting state, at TRAIN_LEAF_REL of each
    one's max."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import leaves_with_paths, unflatten
    from repro_torch.models import layers as L

    cfg = get_config(HYBRID_ARCH)
    d, di, st = cfg.d_model, cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    g = torch.Generator(device=dev).manual_seed(0)
    p = L.init_ssm(cfg, g)
    b, s = 2, HYBRID_SSM_S

    def draw(shape, scale):
        return torch.randn(shape, generator=g, device=dev) * scale

    ins = [draw((b, s, d), 0.5), draw((b, di, st), 0.1),
           draw((b, 3, di), 0.5)]
    gs = [draw((b, s, d), 1.0), draw((b, di, st), 1.0), draw((b, 3, di), 1.0)]
    outs = []
    t0 = time.perf_counter()
    for dv in (dev, torch.device("cpu")):
        leaves = [t.to(dv).requires_grad_()
                  for _, t in leaves_with_paths(p)]
        x, h0, c0 = (t.to(dv).requires_grad_() for t in ins)
        o, (h, c) = L.ssm_block(cfg, unflatten(leaves, p), x, h0, c0)
        loss = sum((a * w.to(dv)).sum() for a, w in zip((o, h, c), gs))
        grads = torch.autograd.grad(loss, leaves + [x, h0])
        outs.append(([t.detach().cpu() for t in (o, h, c)],
                     [t.cpu() for t in grads]))
    secs = time.perf_counter() - t0
    (vc, gc_), (vh, gh) = outs
    err = max(_max_err(a, c) for a, c in zip(vc, vh))
    grad_rel = max(_leaf_rel(a, c) for a, c in zip(gc_, gh))
    print(f"[hybrid] ssm_block at full width (d {d}, {di} inner channels, "
          f"state {st}), float32, {b} x {s} tokens ({s // L.SSM_CHUNK} "
          f"chunks of {L.SSM_CHUNK} + {s % L.SSM_CHUNK}) from given states: "
          f"card vs cpu output and states max abs {err:.3e} (tol "
          f"{ZOO_CROSS_TOL}); gradients through the recomputing backward, "
          f"{len(gh)} tensors, {grad_rel:.2e} of each one's max (tol "
          f"{TRAIN_LEAF_REL}); both sides {secs:.2f} s", flush=True)
    if not (err <= ZOO_CROSS_TOL and grad_rel <= TRAIN_LEAF_REL):
        raise AssertionError(f"[hybrid] ssm_block card vs cpu: outputs "
                             f"{err}, gradients {grad_rel}")


def hybrid_serve(dev, cfg, batch: int, prompt: int, n_dec: int,
                 check_b: int) -> dict:
    """hymba served by `_serve_run` within its ring (prompt = window),
    one decode step under `no_implicit_transfers` (no host sync), the
    decode of `check_b` sequences held against a full forward
    (`_decode_vs_full`), the prefill and 4 decode steps profiled with the
    ``ssm.scan`` range. Returns the launches."""
    import torch

    from repro_torch.analysis.guards import no_implicit_transfers
    from repro_torch.convert import tree_map
    from repro_torch.launch import steps

    run = _serve_run(dev, cfg, batch, prompt, n_dec, "[hybrid]",
                     flash=False)
    print(f"[hybrid] {cfg.name} cache after the prefill: ring "
          f"{tuple(run.cache['kv']['k'].shape)}, ssm "
          f"{tuple(run.cache['ssm'].shape)} float32, conv "
          f"{tuple(run.cache['conv'].shape)}", flush=True)
    torch.cuda.synchronize()
    with no_implicit_transfers():
        lg, _ = steps.make_decode_step(cfg)(run.params, {
            "tokens": run.toks[:, :1], "cache": run.cache,
            "positions": torch.full((batch,), prompt, device=dev)})
    torch.cuda.synchronize()
    if not bool(torch.isfinite(lg[:, :cfg.vocab_size]).all()):
        raise AssertionError(f"[hybrid] {cfg.name}: guarded decode logits "
                             f"are not finite")
    print(f"[hybrid] {cfg.name} a decode step under no_implicit_transfers "
          f"ran with no host sync", flush=True)
    del lg
    _decode_vs_full("[hybrid]", cfg, run.params, run.prompts[:check_b],
                    run.last[:check_b],
                    tree_map(lambda t: t[:, :check_b], run.cache),
                    run.toks[:check_b], note=f" of {check_b} sequences")
    _serve_profiles("[hybrid]", cfg, run, ranges=("ssm.scan",))
    return run.launches


def hybrid_full_width(dev) -> dict:
    """hymba-1.5b at full width and depth served (`hybrid_serve` at
    HYBRID_SERVE), then its ``lm`` steps at HYBRID_LM at full depth and
    its ``dt`` steps at HYBRID_DT (the DT kernel's wide form at D = 1600,
    one launch a step) with n_layers cut to HYBRID_DT_LAYERS, both
    through `launch/train.py`'s functions, the ``lm`` step profiled with
    the SSM's ranges. Prints each cut with its reason. Returns the
    launches of the timed steps and the serving runs."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import decode as dec

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    free()
    print(f"[hybrid] full width: {torch.cuda.memory_allocated() / 2**30:.2f}"
          f" GiB allocated before the phase", flush=True)
    cfg = get_config(HYBRID_ARCH)
    b, p_len, n_dec = HYBRID_SERVE
    print(f"[hybrid] cuts: {cfg.name} served at full width and depth, {b} "
          f"prompts x {p_len} tokens + {n_dec} decode steps (prefill_32k's "
          f"32 x 32,768 and decode_32k's 128 sequences cut to one card's "
          f"run; the prompt fills the {cfg.sliding_window}-slot ring "
          f"exactly, since a longer one loses keys); lm at full depth, "
          f"train_4k's batch 256 -> {HYBRID_LM[0]} x {HYBRID_LM[1]} in "
          f"{HYBRID_LM[2]} micro-batches (reckoned peak about 50 GiB); dt "
          f"at {HYBRID_DT[0]} x {HYBRID_DT[1]} with n_layers "
          f"{cfg.n_layers} -> {HYBRID_DT_LAYERS} (two views' activations "
          f"and direct-attention scores, about 2.7 GB a layer, would take "
          f"about 104 GB at full depth; about 54 GiB cut); lm's warm-up "
          f"and profiled steps take one micro-batch of "
          f"{HYBRID_LM[0] // HYBRID_LM[2]} x {HYBRID_LM[1]} (a full step "
          f"is about half a million launches; a one-sequence batch's "
          f"Eq.-11 weight is 0, so its loss reads 0 for the same work)",
          flush=True)
    t = time.time()
    total = hybrid_serve(dev, cfg, *HYBRID_SERVE, check_b=HYBRID_CHECK_B)
    print(f"[hybrid] serving {time.time() - t:.1f} s", flush=True)
    free()
    for objective, (b, s, nm), n, layers in (
            ("lm", HYBRID_LM, HYBRID_LM_STEPS, cfg.n_layers),
            ("dt", HYBRID_DT, HYBRID_DT_STEPS, HYBRID_DT_LAYERS)):
        t = time.time()
        c = dataclasses.replace(cfg, n_layers=layers)
        params = dec.init_model(c, 0, torch.bfloat16, dev)
        _, counts = _train_run(c, params, objective, b, s, nm, n, dev,
                               ranges=("ssm.scan", "ssm.recompute"),
                               tag="[hybrid]", one_micro=nm > 1)
        total = _add(total, counts)
        del params
        free()
        print(f"[hybrid] {objective} {time.time() - t:.1f} s", flush=True)
    return total


def _set_gates(params) -> None:
    """Every cross block's (gate_attn, gate_mlp) to CROSS_GATES, in
    place."""
    for name, g in zip(("gate_attn", "gate_mlp"), CROSS_GATES):
        params["cross_blocks"][name].fill_(g)


def _free() -> None:
    """Drops what Python no longer holds and the allocator's cache."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _ctx_cross_check(dev, tag, cfg, params, toks, s, aux_full, aux_pre):
    """A model with a context (``audio``, ``vlm``; gates set) in float32
    on the card and with ``device="cpu"`` from the same `params` and
    tokens `toks` (B, s + n): a train-mode forward of all s + n
    positions with the context inputs `aux_full`, then a prefill of s
    with `aux_pre` into s + n slots (the ctx starting at
    enc_ctx_len(s + n) zero rows) and n decode steps that read the ctx
    from the cache; logits and the cache leaves (k, v, ctx) at
    ZOO_CROSS_TOL, positions bitwise; each side's decode logits against
    its own full forward with `aux_pre` at ZOO_CROSS_TOL."""
    import torch

    from repro_torch.convert import tree_map
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T

    cpu = torch.device("cpu")
    v, b, n = cfg.vocab_size, toks.shape[0], toks.shape[1] - s
    (key, x_full), (_, x_pre) = (next(iter(a.items()))
                                 for a in (aux_full, aux_pre))
    outs = []
    for d in (dev, cpu):
        p = tree_map(lambda t: t.to(d), params)
        tk = toks.to(d)
        with torch.no_grad():
            full, _, _ = T.forward(cfg, p, tk,
                                   aux_inputs={key: x_full.to(d)})
            cache = T.init_cache(cfg, b, s + n, dtype=torch.float32,
                                 device=d,
                                 ctx_len=steps.enc_ctx_len(cfg, s + n))
            lg, cache, _ = T.forward(cfg, p, tk[:, :s], mode="prefill",
                                     cache=cache,
                                     aux_inputs={key: x_pre.to(d)})
            logits = [lg[:, -1]]
            for i in range(n):
                lg, cache, _ = T.forward(
                    cfg, p, tk[:, s + i:s + i + 1], mode="decode",
                    cache=cache, positions=torch.full((b,), s + i, device=d))
                logits.append(lg[:, 0])
            same, _, _ = T.forward(cfg, p, tk,
                                   aux_inputs={key: x_pre.to(d)})
        served = torch.stack(logits, 1)[..., :v]
        outs.append((full[..., :v].cpu(), served.cpu(),
                     _max_err(served, same[:, s - 1:, :v]),
                     tree_map(lambda t: t.cpu(), cache)))
    (fc, lc, dc, cc), (fh, lh, dh, ch) = outs
    full_err, err = _max_err(fc, fh), _max_err(lc, lh)
    cache_err = max([_max_err(cc["kv"][k], ch["kv"][k]) for k in ("k", "v")]
                    + [_max_err(cc["ctx"], ch["ctx"])])
    same_pos = torch.equal(cc["kv"]["pos"], ch["kv"]["pos"])
    print(f"{tag} {cfg.name} ({cfg.n_layers} layers) float32, gates "
          f"{CROSS_GATES}: forward {b}x{s + n} with {key} "
          f"{tuple(x_full.shape)}, prefill {b}x{s} with {key} "
          f"{tuple(x_pre.shape)} into {cc['kv']['k'].shape[2]} slots of "
          f"{cc['kv']['k'].shape[0]} layers + {n} decode steps: card vs cpu "
          f"forward logits max abs {full_err:.3e}, prefill and decode logits "
          f"{err:.3e}, cache leaves (k, v, ctx {tuple(cc['ctx'].shape)}) "
          f"{cache_err:.3e}, positions equal {same_pos}; decode vs the full "
          f"forward with the prefill's {key} {dc:.3e} (card), {dh:.3e} "
          f"(cpu) (tol {ZOO_CROSS_TOL})", flush=True)
    if not (max(full_err, err, cache_err, dc, dh) <= ZOO_CROSS_TOL
            and same_pos):
        raise AssertionError(f"{tag} smoke card vs cpu: forward "
                             f"{full_err}, logits {err}, cache {cache_err}, "
                             f"decode vs full {dc} {dh}, positions "
                             f"{same_pos}")


def audio_cross_check(dev):
    """``seamless-m4t-large-v2-smoke`` with CROSS_GATES card vs CPU
    (`_ctx_cross_check`): a forward of 36 positions with 9 frames, a
    prefill of 32 with 8 frames into 36 slots and 4 decode steps; then
    an ``lm`` step in 2 micro-batches and a ``dt`` step with frames
    through `train_cross_check`."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T

    cfg = get_config(AUDIO_ARCH + "-smoke")
    v, b, s, n = cfg.vocab_size, 2, 32, 4
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    _set_gates(params)
    rs = np.random.RandomState(0)
    toks = torch.from_numpy(rs.randint(1, v, (b, s + n)))
    fr_full, fr = (torch.from_numpy(rs.randn(
        *steps.frames_shape(cfg, b, t)).astype(np.float32))
        for t in (s + n, s))
    _ctx_cross_check(dev, "[audio]", cfg, params, toks, s,
                     {"frames": fr_full}, {"frames": fr})
    train_cross_check(dev, AUDIO_ARCH, (("lm", 2, 4, 40), ("dt", 1, 4, 37)),
                      tag="[audio]", dt_loss_spec=True)


def vlm_cross_check(dev):
    """``llama-3.2-vision-90b-smoke`` at VLM_NESTED (2 super-layers of 2
    decoder blocks, the rings 4 flat layers) with CROSS_GATES card vs
    CPU (`_ctx_cross_check`): a forward of 36 positions with patches, a
    prefill of 32 with other patches into 36 slots and 4 decode steps
    that read the projected patches from the cache; then an ``lm`` step
    in 2 micro-batches and a ``dt`` step with patches through
    `train_cross_check`."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config(VLM_ARCH + "-smoke"), **VLM_NESTED)
    v, b, s, n = cfg.vocab_size, 2, 32, 4
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    _set_gates(params)
    rs = np.random.RandomState(0)
    toks = torch.from_numpy(rs.randint(1, v, (b, s + n)))
    pt_full, pt = (torch.from_numpy(rs.randn(
        *steps.patches_shape(cfg, b)).astype(np.float32)) for _ in range(2))
    _ctx_cross_check(dev, "[vlm]", cfg, params, toks, s,
                     {"patches": pt_full}, {"patches": pt})
    train_cross_check(dev, VLM_ARCH, (("lm", 2, 4, 40), ("dt", 1, 4, 37)),
                      tag="[vlm]", dt_loss_spec=True, **VLM_NESTED)


def ctx_serve(dev, cfg, batch: int, prompt: int, n_dec: int,
              check_b: int) -> dict:
    """A model with a context (``audio``: frames (batch, max(prompt //
    4, 8), d_audio); ``vlm``: patches (batch, n_vision_tokens,
    d_vision); drawn on the card from seed 5) served by `_serve_run`
    with CROSS_GATES, one decode step under `no_implicit_transfers` (no
    host sync), the decode of `check_b` sequences held against a full
    forward with the same context inputs (`_decode_vs_full`), the
    prefill and 4 decode steps profiled with the family's ranges
    (AUDIO_RANGES, VLM_RANGES). Returns the launches."""
    import torch

    from repro_torch.analysis.guards import no_implicit_transfers
    from repro_torch.convert import tree_map
    from repro_torch.launch import steps

    tag = f"[{cfg.family}]"
    key, shape = _ctx_input(cfg, batch, prompt)
    ranges = AUDIO_RANGES if cfg.family == "audio" else VLM_RANGES
    g = torch.Generator(device=dev).manual_seed(5)
    ctx_in = torch.randn(shape, generator=g, device=dev)
    run = _serve_run(dev, cfg, batch, prompt, n_dec, tag,
                     aux={key: ctx_in}, prepare=_set_gates)
    gates = [round(float(run.params["cross_blocks"][k][0]), 6)
             for k in ("gate_attn", "gate_mlp")]
    print(f"{tag} {cfg.name} gates (gate_attn, gate_mlp) {gates} in "
          f"every cross block; {key} {tuple(ctx_in.shape)}; cache after "
          f"the prefill: rings {tuple(run.cache['kv']['k'].shape)}, ctx "
          f"{tuple(run.cache['ctx'].shape)} {run.cache['ctx'].dtype}",
          flush=True)
    torch.cuda.synchronize()
    with no_implicit_transfers():
        lg, _ = steps.make_decode_step(cfg)(run.params, {
            "tokens": run.toks[:, :1], "cache": run.cache,
            "positions": torch.full((batch,), prompt, device=dev)})
    torch.cuda.synchronize()
    if not bool(torch.isfinite(lg[:, :cfg.vocab_size]).all()):
        raise AssertionError(f"{tag} {cfg.name}: guarded decode logits "
                             f"are not finite")
    print(f"{tag} {cfg.name} a decode step under no_implicit_transfers "
          f"ran with no host sync", flush=True)
    del lg
    cache = {"kv": tree_map(lambda t: t[:, :check_b], run.cache["kv"]),
             "ctx": run.cache["ctx"][:check_b]}
    _decode_vs_full(tag, cfg, run.params, run.prompts[:check_b],
                    run.last[:check_b], cache, run.toks[:check_b],
                    note=f" of {check_b} sequences",
                    aux={key: ctx_in[:check_b]})
    _serve_profiles(tag, cfg, run, ranges=ranges)
    return run.launches


def audio_full_width(dev) -> dict:
    """seamless-m4t-large-v2 at full width and depth with CROSS_GATES,
    served (`ctx_serve` at AUDIO_SERVE), then its ``lm`` steps at
    AUDIO_LM at full depth and its ``dt`` steps at AUDIO_DT (the DT
    kernel's wide form at D = 1024, one launch a step) with the decoder's
    n_layers cut to AUDIO_DT_LAYERS, both through `launch/train.py`'s
    functions (frames from `make_batch`), profiled with the encoder's
    and the cross blocks' ranges. Prints each cut with its reason.
    Returns the launches of the timed steps and the serving runs."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import decode as dec

    _free()
    print(f"[audio] full width: {torch.cuda.memory_allocated() / 2**30:.2f}"
          f" GiB allocated before the phase", flush=True)
    cfg = get_config(AUDIO_ARCH)
    b, p_len, n_dec = AUDIO_SERVE
    print(f"[audio] cuts: {cfg.name} served at full width and depth "
          f"({cfg.n_encoder_layers} encoder and {cfg.n_layers} decoder "
          f"layers), {b} prompts x {p_len} tokens with {p_len // 4} frames "
          f"each + {n_dec} decode steps (prefill_32k's 32 x 32,768 and "
          f"decode_32k's 128 sequences cut to one card's run); lm at full "
          f"depth, train_4k's batch 256 -> {AUDIO_LM[0]} x {AUDIO_LM[1]} "
          f"in {AUDIO_LM[2]} micro-batches (reckoned peak about 50 GB); dt "
          f"at {AUDIO_DT[0]} x {AUDIO_DT[1]} with the decoder's n_layers "
          f"{cfg.n_layers} -> {AUDIO_DT_LAYERS}, the encoder's "
          f"{cfg.n_encoder_layers} kept (two views' direct-attention "
          f"probabilities and activations, about 1.9 GB a decoder layer, "
          f"would take about 46 GB at full depth beside 20.4 GB of step "
          f"state); lm's warm-up and profiled steps take one micro-batch "
          f"of {AUDIO_LM[0] // AUDIO_LM[2]} x {AUDIO_LM[1]}; gates "
          f"{CROSS_GATES} (the reference's init of 0 keeps the context out "
          f"of the logits)", flush=True)
    t = time.time()
    total = ctx_serve(dev, cfg, *AUDIO_SERVE, check_b=AUDIO_CHECK_B)
    print(f"[audio] serving {time.time() - t:.1f} s", flush=True)
    _free()
    for objective, (b, s, nm), n, layers in (
            ("lm", AUDIO_LM, AUDIO_LM_STEPS, cfg.n_layers),
            ("dt", AUDIO_DT, AUDIO_DT_STEPS, AUDIO_DT_LAYERS)):
        t = time.time()
        c = dataclasses.replace(cfg, n_layers=layers)
        params = dec.init_model(c, 0, torch.bfloat16, dev)
        _set_gates(params)
        _, counts = _train_run(c, params, objective, b, s, nm, n, dev,
                               ranges=AUDIO_RANGES[:2], tag="[audio]",
                               one_micro=nm > 1)
        total = _add(total, counts)
        del params
        _free()
        print(f"[audio] {objective} {time.time() - t:.1f} s", flush=True)
    return total


def vlm_full_width(dev) -> dict:
    """llama-3.2-vision-90b at full width with CROSS_GATES: served
    (`ctx_serve` at VLM_SERVE) with n_layers cut to VLM_SERVE_LAYERS,
    then its ``lm`` steps at VLM_LM and its ``dt`` steps at VLM_DT (the
    DT kernel's wide form at D = 8192, one launch a step) at VLM_TRAIN's
    depth, through `launch/train.py`'s functions (patches from
    `make_batch`), profiled with VLM_RANGES. Prints each cut with its
    reason. Returns the launches of the timed steps and the serving
    runs."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import decode as dec

    _free()
    print(f"[vlm] full width: {torch.cuda.memory_allocated() / 2**30:.2f}"
          f" GiB allocated before the phase", flush=True)
    cfg = get_config(VLM_ARCH)
    serve_cfg = dataclasses.replace(cfg, n_layers=VLM_SERVE_LAYERS)
    train_cfg = dataclasses.replace(cfg, **VLM_TRAIN)
    b, p_len, n_dec = VLM_SERVE
    print(f"[vlm] cuts: {cfg.name} ({cfg.n_layers} layers, a cross block "
          f"every {cfg.cross_attn_period}th, 181 GB of bf16 weights) served "
          f"at full width with n_layers {cfg.n_layers} -> "
          f"{VLM_SERVE_LAYERS} (one period: 4 decoder blocks and one cross "
          f"block, 12.8 GB), {b} prompts x {p_len} tokens with patches "
          f"({b}, {cfg.n_vision_tokens}, {cfg.d_vision}) + {n_dec} decode "
          f"steps (prefill_32k's 32 x 32,768 and decode_32k's 128 sequences "
          f"cut to one card's run; 16 prompts would pass PEAK_GIB: the "
          f"cross block's direct path over {cfg.n_vision_tokens} rows holds "
          f"about 4.4 GB of float32 scores a prompt); trained at full width "
          f"with n_layers {cfg.n_layers} -> {VLM_TRAIN['n_layers']} and a "
          f"cross block every {VLM_TRAIN['cross_attn_period']}nd (the "
          f"reference's reduced() layout: one decoder block and one cross "
          f"block; at 5 layers the step state alone would be 64 GB), lm "
          f"train_4k's batch 256 -> {VLM_LM[0]} x {VLM_LM[1]} in "
          f"{VLM_LM[2]} micro-batches (reckoned peak about 55 GB), dt "
          f"{VLM_DT[0]} x {VLM_DT[1]}; lm's warm-up and profiled steps take "
          f"one micro-batch of {VLM_LM[0] // VLM_LM[2]} x {VLM_LM[1]}; "
          f"gates {CROSS_GATES} (the reference's init of 0 keeps the patches "
          f"out of the logits)", flush=True)
    t = time.time()
    total = ctx_serve(dev, serve_cfg, *VLM_SERVE, check_b=VLM_CHECK_B)
    print(f"[vlm] serving {time.time() - t:.1f} s", flush=True)
    _free()
    def gated():
        params = dec.init_model(train_cfg, 0, torch.bfloat16, dev)
        _set_gates(params)
        return params

    for objective, (b, s, nm), n in (("lm", VLM_LM, VLM_LM_STEPS),
                                     ("dt", VLM_DT, VLM_DT_STEPS)):
        t = time.time()
        # no copy of the params outlives its use here (`gated` made
        # inside, the run's params dropped): a stale 7.1 GiB copy beside
        # the dt step's state and the update's float32 temporaries ran
        # the card out of memory
        counts = _train_run(train_cfg, gated, objective, b, s, nm, n, dev,
                            ranges=VLM_RANGES, tag="[vlm]",
                            one_micro=nm > 1)[1]
        total = _add(total, counts)
        _free()
        print(f"[vlm] {objective} {time.time() - t:.1f} s", flush=True)
    return total


def _zoo_mesh_same(tag, a, b) -> None:
    """Every leaf of tree (or tensor) `a`, gathered from its DTensors,
    bitwise the plain `b`."""
    from repro_torch.convert import leaves_with_paths
    from repro_torch.launch import sharding as sh

    a, b = sh.gather_tree({"x": a}), {"x": b}
    for (path, x), (_, y) in zip(leaves_with_paths(a), leaves_with_paths(b)):
        y = y.to(x.device)                 # a one-card result on the host
        if x.dtype != y.dtype or x.shape != y.shape or not bool(
                (x == y).all()):
            raise AssertionError(f"[zoo_mesh] {tag} {'/'.join(path[1:])}: "
                                 f"the mesh step differs from the one-card "
                                 f"step by {_max_err(x, y)}")


def _zoo_mesh_timed(fn):
    """(fn()'s result, seconds on the host clock, synchronised)."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def zoo_mesh_path(dev) -> dict:
    """[zoo_mesh]: the mesh steps at world size 1 (ZOO_MESH_*), each
    against the same step without a mesh, bitwise: the first mesh call
    (DTensor's sharding propagation fills its caches) and a second one
    timed, the one-card step timed once (tinyllama's and olmoe's shapes
    warmed by [dense] and [moe]; the other rows' one-card time includes
    its first call at their shapes), the peak memory of the mesh calls,
    the one-card step's result held meanwhile. Launches are counted over
    the mesh calls only; returns them, a call's worth."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.convert import tree_map
    from repro_torch.launch import decode as dec
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps as st
    from repro_torch.launch import train as tr

    t_phase = time.time()
    _free()
    smi = _smi()
    mesh = M.zoo_mesh(1, 1, device=dev)
    print(f"[zoo_mesh] (data=1, model=1) zoo mesh over the "
          f"{torch.distributed.get_backend()} group of "
          f"{torch.distributed.get_world_size()} rank(s); one card, no "
          f"speed-up is claimed for the sharding; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
          f"before the phase", flush=True)
    total: dict = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for arch in ZOO_MESH_ARCHS:
            cfg = dataclasses.replace(get_config(arch),
                                      **ZOO_MESH_CUTS.get(arch, {}))
            if cfg.family == "dense":
                objective, (b, s, nm) = "dt", ZOO_MESH_DT
            elif cfg.family == "moe":
                objective, (b, s, nm) = "lm", ZOO_MESH_LM
            else:
                objective, (b, s, nm) = "lm", ZOO_MESH_FAMILY_LM.get(
                    arch, ZOO_MESH_FAMILY_LM["*"])
            t_row = time.time()
            params = dec.init_model(cfg, 0, torch.bfloat16, dev)
            if "cross_blocks" in params:
                _set_gates(params)
            placed = st.shard_params(cfg, params, mesh)
            # at world size 1 each local shard is the whole leaf: the
            # one-card steps read those, not a second copy of the weights
            params = tree_map(lambda t: t.to_local(), placed)
            shape = InputShape(objective, s, b, "train")
            batch = tr.make_batch(cfg, shape, 0, 0, dev, objective)
            one, _ = st.make_train_step(cfg, shape, objective=objective,
                                        n_micro=nm)
            on_mesh, _ = st.make_train_step(cfg, shape, mesh,
                                            objective=objective, n_micro=nm)
            (p1, m1, met1), t_one = _zoo_mesh_timed(
                lambda: one(params, st.init_momentum(params), batch))
            if arch in ZOO_MESH_HOST:     # the one-card result to the host
                p1, m1 = (tree_map(lambda t: t.cpu(), t) for t in (p1, m1))
            _free()            # the allocator's cache back before the mesh
            t_train = time.time()
            torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            _, t_first = _zoo_mesh_timed(
                lambda: on_mesh(placed, st.init_momentum(placed), batch))
            _free()
            (p2, m2, met2), t_mesh = _zoo_mesh_timed(
                lambda: on_mesh(placed, st.init_momentum(placed), batch))
            counts = _counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
            _zoo_mesh_same(f"{arch} {objective} loss", met2["loss"],
                           met1["loss"])
            _zoo_mesh_same(f"{arch} {objective} params", p2, p1)
            _zoo_mesh_same(f"{arch} {objective} momentum", m2, m1)
            want = {k: 0 for k in counts}
            want["dt_loss_wide"] = 2 * nm if objective == "dt" else 0
            views = 2 if objective == "dt" else 1
            want["rwkv6"] = (2 * views * nm * cfg.n_layers
                             if cfg.family == "ssm" else 0)
            if counts != want:
                raise AssertionError(f"[zoo_mesh] {arch} {objective} "
                                     f"launches {counts}, want {want}")
            total = _add(total, {k: v // 2 for k, v in counts.items()})
            print(f"[zoo_mesh] {arch} {objective} bfloat16 {b} x {s} in "
                  f"{nm} micro-batch(es), {_zoo_mesh_depth(cfg)}: mesh step "
                  f"{t_mesh:.4f} s (first {t_first:.4f} s), one-card step "
                  f"{t_one:.4f} s; loss {float(met2['loss']):.6f}, params "
                  f"and momentum bitwise the one-card step's; peak "
                  f"{peak:.2f} GiB; launches a mesh step "
                  f"{ {k: v // 2 for k, v in counts.items() if v} }; "
                  f"{smi}", flush=True)
            del p1, m1, p2, m2, batch
            _free()
            t_serve = time.time()
            total = _add(total, _zoo_mesh_serve(dev, cfg, params, placed,
                                                mesh, smi))
            del params, placed
            _free()
            t_end = time.time()
            print(f"[zoo_mesh] {arch}: {t_end - t_row:.1f} s for the row "
                  f"(params and the one-card step "
                  f"{t_train - t_row:.1f} s, the mesh steps and checks "
                  f"{t_serve - t_train:.1f} s, serve {t_end - t_serve:.1f} "
                  f"s)", flush=True)
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"[zoo_mesh] {time.time() - t_phase:.1f} s in the phase; "
          f"launches on the mesh {total}", flush=True)
    return total


def _zoo_mesh_depth(cfg) -> str:
    """A row's depth as its print gives it (the cuts of ZOO_MESH_CUTS)."""
    if cfg.family == "audio":
        return (f"{cfg.n_layers} decoder and {cfg.n_encoder_layers} "
                f"encoder layers")
    if cfg.family == "vlm":
        return (f"{cfg.n_layers} layers, a cross block every "
                f"{cfg.cross_attn_period}")
    return f"{cfg.n_layers} layers"


def _zoo_mesh_serve(dev, cfg, params, placed, mesh, smi) -> dict:
    """ZOO_MESH_SERVE's prefill (with the context input of the audio and
    vlm families) and greedy decode steps with and without the mesh:
    each step's logits and the final cache bitwise. The mesh runs twice,
    first with one decode step (DTensor's sharding propagation fills its
    caches), then timed. Returns the mesh runs' launches, a run's worth:
    rwkv6 once a layer of the prefill for the ``ssm`` family, nothing
    else."""
    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.launch import decode as dec
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps as st

    b, p_len, n_dec = ZOO_MESH_SERVE
    total = p_len + n_dec
    prompts = dec.random_prompts(cfg, b, p_len, 0, dev)
    batch = {"tokens": prompts}
    ctx = _ctx_input(cfg, b, p_len)
    if ctx is not None:
        gen = torch.Generator(device=dev).manual_seed(2)
        batch[ctx[0]] = torch.randn(ctx[1], generator=gen, device=dev)

    def serve(mesh_, n=n_dec):
        pre = st.make_prefill_step(cfg, InputShape("p", total, b, "prefill"),
                                   torch.bfloat16, mesh=mesh_)
        decode = st.make_decode_step(cfg, InputShape("d", total, b, "decode"),
                                     mesh=mesh_)
        p = params if mesh_ is None else placed
        (last, cache), t_pre = _zoo_mesh_timed(lambda: pre(p, dict(batch)))
        logits, secs = [last], []
        tok = dec.greedy(cfg, sh.full(last))
        for i in range(n):
            pos = torch.full((b,), p_len + i, dtype=torch.int64, device=dev)
            (lg, cache), t_ = _zoo_mesh_timed(lambda: decode(p, {
                "tokens": tok, "positions": pos, "cache": cache}))
            logits.append(lg)
            secs.append(t_)
            tok = dec.greedy(cfg, sh.full(lg))
        return logits, cache, t_pre, secs

    one = serve(None)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    first = serve(mesh, 1)     # fills DTensor's caches: one decode step
    got = serve(mesh)
    counts = _counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, (x, y) in enumerate(zip(got[0], one[0])):
        _zoo_mesh_same(f"{cfg.name} serve logits {i}", x, y)
    _zoo_mesh_same(f"{cfg.name} serve cache", got[1], one[1])
    want = {k: 0 for k in counts}
    want["rwkv6"] = 2 * cfg.n_layers if cfg.family == "ssm" else 0
    if counts != want:
        raise AssertionError(f"[zoo_mesh] {cfg.name} serve launched "
                             f"{counts}, want {want}")
    med = sorted(got[3])[len(got[3]) // 2]
    print(f"[zoo_mesh] {cfg.name} served {b} x {p_len} + {n_dec} decode "
          f"steps on the mesh{' with ' + ctx[0] if ctx else ''}: prefill "
          f"{got[2]:.4f} s (first {first[2]:.4f} s; one-card "
          f"{one[2]:.4f} s), decode median {med * 1e3:.2f} ms a step "
          f"(one-card {sorted(one[3])[len(one[3]) // 2] * 1e3:.2f} ms); "
          f"every logit and the cache bitwise the one-card run's; peak "
          f"{peak:.2f} GiB; launches a run "
          f"{ {k: v // 2 for k, v in counts.items() if v} }; {smi}",
          flush=True)
    return {k: v // 2 for k, v in counts.items()}


def _coll_text(coll: dict) -> str:
    return ", ".join(f"{k} {coll[k]:.4e} B in {coll['count_' + k]}"
                     for k in coll if not k.startswith("count_"))


def dryrun_start() -> dict:
    """Starts [dryrun]'s two subprocesses, which need no card and run
    beside [zoo_mesh]: the dry run's CLI for DRYRUN_ARCH at prefill_32k
    on the (16, 16) fake world, and its (1, 1) fake trace of a
    DRYRUN_PREFILL prefill, each writing a JSON file into a temporary
    directory under build/."""
    import tempfile

    b, s = DRYRUN_PREFILL
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_",
                           dir=os.path.join(ROOT, "build"))
    out, one = os.path.join(tmp, "dryrun.json"), os.path.join(tmp, "one.json")
    cmds = [[sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             DRYRUN_ARCH, "--shape", "prefill_32k", "--mesh", "single",
             "--out", out],
            [sys.executable, "-c", _ONE_CARD_TRACE, one, DRYRUN_ARCH,
             str(b), str(s)]]
    env = dict(os.environ, PYTHONPATH=SRC)
    logs = [os.path.join(tmp, f"log{i}.txt") for i in range(len(cmds))]
    procs = []
    for c, log in zip(cmds, logs):
        # a file, not a pipe: nothing reads the output until [dryrun]
        with open(log, "w") as f:
            procs.append(subprocess.Popen(c, env=env, cwd=ROOT, stdout=f,
                                          stderr=subprocess.STDOUT))
    return {"tmp": tmp, "out": out, "one": one, "cmds": cmds,
            "procs": procs, "logs": logs}


def dryrun_stop(started: dict) -> None:
    """Kills what is left of `dryrun_start`'s subprocesses and removes
    their directory."""
    import shutil

    for p in started["procs"]:
        if p.poll() is None:
            p.kill()
            p.wait()
    shutil.rmtree(started["tmp"], ignore_errors=True)


def dryrun_path(dev, started: dict) -> None:
    """[dryrun]: the dry run's record of DRYRUN_ARCH at prefill_32k on
    the 256 fake ranks of the (16, 16) mesh and its (1, 1) fake trace of
    a DRYRUN_PREFILL prefill (`dryrun_start`'s subprocesses), beside
    that prefill on the card: the arguments and outputs the dry run
    counts must be the card's, byte for byte."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.convert import leaves_with_paths
    from repro_torch.launch import decode as dec
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import steps as st

    t_phase = time.time()
    b, s = DRYRUN_PREFILL
    cfg = get_config(DRYRUN_ARCH)
    shape = InputShape("prefill", s, b, "prefill")
    _free()
    base = torch.cuda.memory_allocated(dev)
    params = dec.init_model(cfg, 0, torch.bfloat16, dev)
    tokens = dec.random_prompts(cfg, b, s, 0, dev)
    have = sum(t.nbytes for _, t in leaves_with_paths(params)) \
        + tokens.nbytes
    want = dr.rank_bytes(cfg, shape, dr.ShapeMesh((1, 1), dr.ZOO_AXES))
    if want["argument_bytes"] != have:
        raise AssertionError(f"[dryrun] rank_bytes on (1, 1): {want}; the "
                             f"params and tokens on the card hold {have} "
                             f"bytes")
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    logits, cache = st.make_prefill_step(cfg, shape)(params,
                                                     {"tokens": tokens})
    torch.cuda.synchronize(dev)
    growth = torch.cuda.max_memory_allocated(dev) - before
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("[dryrun] the card's prefill logits are not "
                             "finite")
    out_bytes = logits.nbytes + sum(t.nbytes for _, t in
                                    leaves_with_paths(cache))
    del params, tokens, logits, cache
    t_wait = time.time()
    for p, c, log in zip(started["procs"], started["cmds"],
                         started["logs"]):
        if p.wait(timeout=DRYRUN_TIMEOUT_S):
            with open(log) as f:
                raise RuntimeError(f"[dryrun] {' '.join(c[1:4])} exited "
                                   f"{p.returncode}: {f.read()[-3000:]}")
    t_wait = time.time() - t_wait
    with open(started["out"]) as f:
        rec = json.load(f)[f"{DRYRUN_ARCH}|prefill_32k|single|lm"]
    with open(started["one"]) as f:
        small = json.load(f)
    if not rec.get("ok"):
        raise AssertionError(f"[dryrun] prefill_32k on 16x16 failed: "
                             f"{rec.get('error')}")
    mem, cost = rec["memory"], rec["cost"]
    print(f"[dryrun] {DRYRUN_ARCH} prefill_32k (32 x 32768) on the "
          f"{rec['mesh']} fake world ({rec['world_size']} ranks, "
          f"{rec['device_type']} mesh), a rank: flops {cost['flops']:.4e} "
          f"(kernels {cost['kernel_flops']}), bytes accessed "
          f"{cost['bytes accessed']:.4e} ({cost['bytes_basis']}); "
          f"collectives {_coll_text(rec['collectives'])}; argument "
          f"{mem['argument_bytes']} B, output {mem['output_bytes']} B, temp "
          f"{mem['temp_bytes']} B, peak {mem['peak_bytes']} B; trace "
          f"{rec['trace_s']} s, {rec['total_s']} s in all", flush=True)
    m1 = small["memory"]
    if m1["argument_bytes"] != have or m1["output_bytes"] != out_bytes:
        raise AssertionError(f"[dryrun] the (1, 1) trace counts arguments "
                             f"{m1['argument_bytes']} B and outputs "
                             f"{m1['output_bytes']} B; the card's prefill "
                             f"took {have} B and returned {out_bytes} B")
    est = m1["argument_bytes"] + m1["temp_bytes"]
    measured = before - base + growth
    print(f"[dryrun] one card, {b} x {s} prefill: arguments {have} B "
          f"(rank_bytes on (1, 1): equal), outputs {out_bytes} B (the "
          f"(1, 1) trace: equal); estimate argument + temp {est} B "
          f"({est / 2**30:.2f} GiB) against the card's {measured} B "
          f"({measured / 2**30:.2f} GiB: allocated {before - base} B + peak "
          f"growth {growth} B), ratio {est / measured:.4f}; temp "
          f"{m1['temp_bytes']} B against growth {growth} B, ratio "
          f"{m1['temp_bytes'] / growth:.4f}; (1, 1) trace "
          f"{small['trace_s']} s", flush=True)
    _free()
    print(f"[dryrun] {time.time() - t_phase:.1f} s in the phase ({t_wait:.1f} "
          f"s of it waiting on the subprocesses, started before "
          f"[zoo_mesh])", flush=True)


def analysis_path(dev, first_build) -> None:
    """[analysis]: the guards live on the card, the registries' contracts
    and the port's lint clean. `first_build` is the tracker around the
    script's first `build.build_all()`."""
    import torch

    from repro_torch.analysis import contracts, lint
    from repro_torch.analysis.guards import (no_implicit_transfers,
                                             track_compiles)
    from repro_torch.kernels import build

    x = torch.arange(4.0, device=dev)
    torch.cuda.synchronize()

    def guarded(fn) -> str:
        """The error `fn()` raises inside the guard ('' when none); the
        sync debug mode must be back to its value after the block."""
        prev = torch.cuda.get_sync_debug_mode()
        err = ""
        with no_implicit_transfers():
            try:
                fn()
            except RuntimeError as e:
                err = str(e).splitlines()[0]
        if torch.cuda.get_sync_debug_mode() != prev:
            raise AssertionError(f"[analysis] sync debug mode "
                                 f"{torch.cuda.get_sync_debug_mode()} after "
                                 f"the guard, {prev} before")
        return err

    caught = {"item": guarded(lambda: x.sum().item()),
              "cpu": guarded(lambda: x.cpu()),
              "synchronize": guarded(torch.cuda.synchronize)}
    if not (caught["item"] and caught["cpu"]):
        raise AssertionError(f"[analysis] no_implicit_transfers let a "
                             f"fetch through: {caught}")
    with track_compiles() as again:
        build.build_all()
    if again.kernel_builds:
        raise AssertionError(f"[analysis] a second build_all built "
                             f"{again.kernel_builds} libraries")
    t = time.perf_counter()
    violations = contracts.check_all()
    t_contracts = time.perf_counter() - t
    if violations:
        raise AssertionError("[analysis] contracts: "
                             + "; ".join(map(str, violations)))
    t = time.perf_counter()
    with contextlib.chdir(ROOT):
        findings = lint.apply_baseline(
            lint.lint_paths([os.path.join("src", "repro_torch")]),
            lint.load_baseline(lint.DEFAULT_BASELINE))
    t_lint = time.perf_counter() - t
    if findings:
        raise AssertionError("[analysis] lint: "
                             + "; ".join(f.format() for f in findings))
    print(f"[analysis] no_implicit_transfers raises on .item(): "
          f"{caught['item']!r}; on .cpu(): {caught['cpu']!r}; on "
          f"torch.cuda.synchronize(): {caught['synchronize'] or 'no'}; "
          f"kernel builds around the first build_all "
          f"{first_build.kernel_builds}, around a second 0; contracts "
          f"0 violations in {t_contracts:.2f} s; lint 0 findings in "
          f"{t_lint:.2f} s", flush=True)


def run() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.analysis.guards import track_compiles
    from repro_torch.kernels import build
    from repro_torch.runtime import set_parity_mode

    t_start = time.time()
    smi = _smi()
    print(f"[card] {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    t = time.time()
    with track_compiles() as first_build:
        libs = build.build_all()
    print(f"[build] {len(libs)} kernels in {time.time() - t:.2f} s: "
          f"{[os.path.basename(p) for p in libs]}", flush=True)
    set_parity_mode()
    dev = torch.device("cuda", 0)
    rows = kernel_phase(dev) + q8_kernels(dev)
    analysis_path(dev, first_build)
    cross_check(dev)
    launches, main_sc, main_state = main_path(dev)
    comms_launches, sc, state, store = comms_path(dev, main_sc, main_state)
    topo_cross_check(dev)
    paths = {"main": launches, "comms": comms_launches,
             "batched": batched_path(dev, main_sc.data),
             "resume": resume_path(dev, main_sc.data),
             "engine": engine_path(dev, main_sc.data),
             "multi": multi_path(dev, main_sc.data),
             "mesh": mesh_path(dev, main_sc.data),
             "handover": handover_path(dev, main_sc.data),
             "fedco": fedco_path(dev, main_sc.data)}
    probe_path(dev, main_sc, main_state)
    serve_path(store)
    threaded_serve(sc, state)
    lossless_round(dev, main_sc.data, state)
    # the FL paths' data, states and store are done with: free them for
    # the zoo's full-width phases
    del main_sc, main_state, sc, state, store
    _free()
    rows.append(rwkv6_kernel_check(dev))
    zoo_cross_check(dev)
    paths["zoo"] = zoo_launches = zoo_full_width(dev)
    rwkv6_grad_check(dev)
    rows.append(dt_wide_check(dev))
    train_cross_check(dev)
    paths["train"] = train_launches = train_full_width(dev)
    _free()
    dense_cross_check(dev)
    paths["dense"] = dense_full_width(dev)
    _free()
    moe_cross_check(dev)
    moe_block_check(dev)
    paths["moe"] = moe_full_width(dev)
    _free()
    hybrid_cross_check(dev)
    hybrid_ssm_check(dev)
    paths["hybrid"] = hybrid_full_width(dev)
    _free()
    audio_cross_check(dev)
    paths["audio"] = audio_full_width(dev)
    _free()
    vlm_cross_check(dev)
    paths["vlm"] = vlm_full_width(dev)
    _free()
    dry = dryrun_start()        # [dryrun]'s subprocesses, beside [zoo_mesh]
    try:
        paths["zoo_mesh"] = zoo_mesh_path(dev)
        dryrun_path(dev, dry)
    finally:
        dryrun_stop(dry)
    for r in rows:      # each kernel's count on the path that runs it
        path = (comms_launches if r["name"].startswith("q8")
                else zoo_launches if r["name"] == "rwkv6"
                else train_launches if r["name"] == "dt_loss_wide"
                else launches)
        r["launches"] = path[r["name"]]
        r["paths"] = {p: c[r["name"]] for p, c in paths.items()}
    print(f"[time] {time.time() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = run()
    except Exception:   # any failed phase: report and exit non-zero
        traceback.print_exc()
        code = 1
    sys.exit(code)
