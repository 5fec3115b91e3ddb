"""Client update algorithms, the ``CLIENT_UPDATES`` registry —
counterpart of `repro.core.clients` (`_client_loss`,
`make_local_train_step`, `make_moco_local_train_step`, `DTSSLClient`,
`FedCoClient`).

Every entry has the reference's three hooks, so every topology runs any
client algorithm the same way:

  init_state(cfg, global_tree)          -> client_state (or None)
  run_cohort(cfg, tree, client_state,
             batches, draws, lr,
             parallel, pad_to[, mesh])   -> (CohortBatch, uploads)
  finalize(cfg, client_state,
           aggregated_tree, uploads)     -> new client_state

`draws` holds, per client, one (pi1, pi2) draw pair per local iteration
(core/ssl.py). `uploads` is what the vehicles send besides their trees
(FedCo: each client's k-vectors of its last local iteration; DT-SSL:
None). The trained trees land in the rows of the cohort's flat buffer
(core/cohort.py).

DT-SSL trains the cohort in one of two ways, as the reference does:
* ``parallel=True`` (the default) is the reference's vmapped step: the
  client step (`client_step`, written for `torch.func`) runs under
  `torch.func.vmap` over a chunk of CLIENTS_PER_CHUNK clients, the init
  tree unbatched, so the first iteration's forward runs one weight over
  the chunk's images, BN statistics stay per client and the DT loss is
  one kernel launch a chunk (kernels/ops.py). `pad_to` pads the cohort
  to that many rows by repeating the last client's batch and draws (no
  random numbers drawn); the extra rows train and are masked out.
* ``parallel=False`` trains client by client through autograd: the
  port's own oracle for the batched step.
FedCo is sequential either way, as the reference's is.

With a cohort mesh of more than one rank (``mesh``, launch/mesh.py;
`collectives.is_sharded`),
DT-SSL's batched step shards the cohort: each rank trains its block of
rows (`train_sharded`) and returns the cohort sharded (core/cohort.py),
the losses gathered. A block batches fewer clients than the whole
cohort, so this is float-close, not bitwise, against the unsharded step,
as in the reference.

DT-SSL's loss is the fused DT kernel (`kernels.ops.dt_loss`); the
reference's client differentiates the jnp `dt_loss_matrix`, which
computes the same function. FedCo's InfoNCE is plain torch, as the
reference's is jnp.
"""
from __future__ import annotations

import torch

from repro_torch.convert import (flat_spec, leaves_with_paths, tree_map,
                                 unflatten)
from repro_torch.core import ssl
from repro_torch.core.cohort import CohortBatch
from repro_torch.core.collectives import (all_gather_rows, axis_size,
                                          is_sharded)
from repro_torch.core.dt_loss import info_nce_loss
from repro_torch.core.state import FLConfig
from repro_torch.kernels import ops
from repro_torch.models.resnet import resnet_apply
from repro_torch.optim.optimizers import sgd


def client_loss(tree: dict, cfg: FLConfig, images: torch.Tensor,
                d1: dict, d2: dict):
    """pi1/pi2 views -> encoder twice -> DT loss. Returns (loss,
    new_tree); the BN state threads through both passes."""
    q, _, tree1 = resnet_apply(tree, ssl.pi1(images, d1), train=True)
    k, _, tree2 = resnet_apply(tree1, ssl.pi2(images, d2), train=True)
    return ops.dt_loss(q, k, cfg.tau_alpha, cfg.tau_beta), tree2


def _trainable(params: dict) -> dict:
    return tree_map(lambda t: t.detach().requires_grad_(True), params)


# Clients a chunk of the batched step. The step's peak memory grows with
# the images it holds for the backward: about 18 MB an image and a view
# at full width (`resnet_apply` keeps its activations, and its BN three
# maps where one would do), so about 18.5 GB a client at the Table-1
# batch (two views of 512 images). A Table-1 round may take at most
# 64 GiB of the 80 GB card. Measured on an H100 80GB HBM3 (chip_smoke.py
# [batched]): chunks of 3 peak at 51.7 GiB, chunks of 4 at 69.0 GiB; the
# whole cohort of 5 would not fit.
CLIENTS_PER_CHUNK = 3


def _sgd_step(opt_update, params: dict, loss, opt_state, lr: float):
    """One SGD update of the `_trainable` params from d loss / d params.
    Returns (new params, new optimizer state), detached."""
    leaves = [leaf for _, leaf in leaves_with_paths(params)]
    grads = unflatten(torch.autograd.grad(loss, leaves), params)
    with torch.no_grad():
        return opt_update(tree_map(torch.Tensor.detach, params), grads,
                          opt_state, lr)


def local_train(cfg: FLConfig, tree: dict, images: torch.Tensor,
                draws: list, lr: float):
    """cfg.local_iters SGD steps on one client from `tree`; `draws` holds
    one (pi1, pi2) draw pair per iteration. Returns (tree, mean loss)."""
    opt_init, opt_update = sgd(cfg.momentum, cfg.weight_decay)
    opt_state = opt_init(tree["params"])
    losses = []
    for d1, d2 in draws:
        params = _trainable(tree["params"])
        loss, t2 = client_loss({"params": params, "state": tree["state"]},
                               cfg, images, d1, d2)
        new_params, opt_state = _sgd_step(opt_update, params, loss,
                                          opt_state, lr)
        tree = {"params": new_params,
                "state": tree_map(torch.Tensor.detach, t2["state"])}
        losses.append(loss.detach())
    return tree, torch.stack(losses).mean()


def _loss_and_state(params: dict, state: dict, cfg: FLConfig,
                    images: torch.Tensor, d1: dict, d2: dict):
    """`client_loss` as `torch.func.grad` takes it: (loss, (loss, new
    BN state))."""
    loss, t2 = client_loss({"params": params, "state": state}, cfg, images,
                           d1, d2)
    return loss, (loss, t2["state"])


def client_step(cfg: FLConfig, tree: dict, images: torch.Tensor,
                draws: list, lr: float):
    """`local_train` in `torch.func` form: the gradient by
    `torch.func.grad`, nothing in place, so it runs under
    `torch.func.vmap` (the batched cohort step). Returns (tree, mean
    loss)."""
    opt_init, opt_update = sgd(cfg.momentum, cfg.weight_decay)
    params, state = tree["params"], tree["state"]
    opt_state = opt_init(params)
    losses = []
    for d1, d2 in draws:
        grads, (loss, state) = torch.func.grad(_loss_and_state, has_aux=True)(
            params, state, cfg, images, d1, d2)
        params, opt_state = opt_update(params, grads, opt_state, lr)
        losses.append(loss)
    return {"params": params, "state": state}, torch.stack(losses).mean()


def train_chunks(cfg: FLConfig, tree: dict, images: torch.Tensor,
                 draws: list, lr, cohort: CohortBatch,
                 tree_batched: bool = False) -> None:
    """The batched client step over a cohort, CLIENTS_PER_CHUNK clients a
    `torch.func.vmap`: client i's trained tree and mean loss go into row
    i of `cohort` (in place). images (m, B, H, W, C); draws one (pi1,
    pi2) pair a local iteration, each draw tensor stacked over the m
    clients (`_stack_draws`); `tree` is every client's init tree, or with
    `tree_batched` each leaf (m, ...), client i's init tree in row i (the
    handover's engine body). `lr` is a float or a 0-d float32 tensor."""
    step = torch.func.vmap(
        lambda t, x, d: client_step(cfg, t, x, d, lr),
        in_dims=(0 if tree_batched else None, 0, 0))
    for i0 in range(0, images.shape[0], CLIENTS_PER_CHUNK):
        sl = slice(i0, i0 + CLIENTS_PER_CHUNK)
        t = tree_map(lambda a: a[sl], tree) if tree_batched else tree
        chunk = [tuple({k: v[sl] for k, v in d.items()} for d in pair)
                 for pair in draws]
        trees, losses = step(t, images[sl], chunk)
        cohort.write_rows(i0, trees, losses)


def train_sharded(cfg: FLConfig, tree: dict, images: torch.Tensor,
                  draws: list, lr, mesh, n: int) -> CohortBatch:
    """This rank's block of a cohort sharded over `mesh` through the
    batched step: images (b, B, H, W, C) and the draws stacked over the
    block's b clients, rows [r b, (r + 1) b) of a cohort of b x ranks
    rows, the first n valid. Returns the sharded cohort (its `flat` the
    block), the losses all-gathered."""
    b = images.shape[0]
    block = CohortBatch.empty(flat_spec(tree), b, device=images.device)
    train_chunks(cfg, tree, images, draws, lr, block)
    losses = all_gather_rows(block.losses)
    m = losses.shape[0]
    # analysis: allow=retrace-fresh-array -- the (m,) validity mask, made
    # on the card (no upload)
    return CohortBatch(flat=block.flat, spec=block.spec, losses=losses,
                       mask=(torch.arange(m, device=losses.device) < n)
                       .float(), n=n, mesh=mesh,
                       row0=CohortBatch.sharding_spec(mesh, m).start)


def _stack_draws(draws: list) -> list:
    """Clients' per-iteration (pi1, pi2) draw pairs -> one pair a
    iteration, each draw tensor stacked along a leading client axis."""
    def stack(ds):
        return {k: torch.stack([d[k] for d in ds]) for k in ds[0]}
    return [tuple(stack([c[it][v] for c in draws]) for v in (0, 1))
            for it in range(len(draws[0]))]


def _pad_inputs(batches: list, draws: list, pad_to):
    """The cohort's inputs padded to `pad_to` clients by repeating the
    last client's batch and draws; no random numbers are drawn."""
    n = len(batches)
    m = n if pad_to is None else int(pad_to)
    if m < n:
        raise ValueError(f"pad_to={pad_to} smaller than cohort size {n}")
    return (list(batches) + [batches[-1]] * (m - n),
            list(draws) + [draws[-1]] * (m - n))


def moco_local_train(cfg: FLConfig, tree: dict, key_tree: dict,
                     queue: torch.Tensor, images: torch.Tensor, draws: list,
                     lr: float):
    """FedCo client: cfg.local_iters SGD steps of InfoNCE against the
    global `queue`, the key encoder (`key_tree`, train=False, no
    gradient) an EMA of the query params with cfg.moco_momentum and the
    query's new BN state. Returns (tree, key_tree, k-vectors of the last
    iteration, mean loss)."""
    opt_init, opt_update = sgd(cfg.momentum, cfg.weight_decay)
    opt_state = opt_init(tree["params"])
    losses, kvec = [], None
    for d1, d2 in draws:
        params = _trainable(tree["params"])
        q, _, t2 = resnet_apply({"params": params, "state": tree["state"]},
                                ssl.pi1(images, d1), train=True)
        with torch.no_grad():
            kvec, _, _ = resnet_apply(key_tree, ssl.pi2(images, d2),
                                      train=False)
        loss = info_nce_loss(q, kvec, queue)
        new_params, opt_state = _sgd_step(opt_update, params, loss,
                                          opt_state, lr)
        new_state = tree_map(torch.Tensor.detach, t2["state"])
        tree = {"params": new_params, "state": new_state}
        key_tree = {"params": ssl.momentum_update(key_tree["params"],
                                                  new_params,
                                                  cfg.moco_momentum),
                    "state": new_state}
        losses.append(loss.detach())
    return tree, key_tree, kvec, torch.stack(losses).mean()


def _empty_cohort(tree: dict, batches: list, n=None) -> CohortBatch:
    return CohortBatch.empty(flat_spec(tree), len(batches), n=n,
                             device=batches[0].device)


class DTSSLClient:
    """FLSimCo Step 2: dual-temperature contrastive SSL. Stateless."""

    name = "dtssl"

    def init_state(self, cfg: FLConfig, global_tree: dict):
        return None

    def run_cohort(self, cfg: FLConfig, tree: dict, client_state,
                   batches: list, draws: list, lr: float,
                   parallel: bool = True, pad_to=None, mesh=None):
        """Train each client from `tree` on its batch with its draws;
        returns (the cohort with client i's tree in row i, None).
        `parallel` vmaps the step over chunks of CLIENTS_PER_CHUNK
        clients, and only then do `pad_to` pad the cohort and `mesh`
        shard it (see the module docstring), as in the reference; with a
        mesh the cohort is padded on to a multiple of its ranks."""
        if not parallel:
            cohort = _empty_cohort(tree, batches)
            for i, (images, client_draws) in enumerate(zip(batches, draws)):
                t, loss = local_train(cfg, tree, images, client_draws, lr)
                cohort.write(i, t, loss)
            return cohort, None
        n = len(batches)
        if is_sharded(mesh):
            ext = axis_size(mesh)
            m = -(-(pad_to or n) // ext) * ext
            batches, draws = _pad_inputs(batches, draws, m)
            blk = CohortBatch.sharding_spec(mesh, m)
            return train_sharded(cfg, tree, torch.stack(batches[blk]),
                                 _stack_draws(draws[blk]), lr, mesh,
                                 n), None
        batches, draws = _pad_inputs(batches, draws, pad_to)
        cohort = _empty_cohort(tree, batches, n)
        train_chunks(cfg, tree, torch.stack(batches), _stack_draws(draws),
                     lr, cohort)
        return cohort, None

    def finalize(self, cfg: FLConfig, client_state, aggregated_tree,
                 uploads):
        return None


class FedCoClient:
    """FedCo baseline: MoCo with a global negative queue. Vehicles upload
    their k-vectors beside their trees; the RSU puts them in front of the
    queue and resets the key encoder to the aggregated model."""

    name = "fedco"

    def init_state(self, cfg: FLConfig, global_tree: dict) -> dict:
        """The key encoder a copy of the global tree; the (queue_len,
        feature_dim) queue normal draws from a generator seeded with
        cfg.seed + 1, rows normalized, on the tree's device."""
        device = leaves_with_paths(global_tree)[0][1].device
        gen = torch.Generator().manual_seed(cfg.seed + 1)
        return {"key_tree": tree_map(torch.clone, global_tree),
                "queue": ssl.normal_queue(gen, cfg.queue_len,
                                          cfg.feature_dim, device)}

    def run_cohort(self, cfg: FLConfig, tree: dict, client_state: dict,
                   batches: list, draws: list, lr: float,
                   parallel: bool = True, pad_to=None):
        """Each client from `tree`, the round's key encoder and queue;
        returns (the cohort, each client's k-vectors in cohort order).
        Sequential whatever `parallel` says, as the reference's is: the
        key encoder's EMA threads through each client's steps. `pad_to`
        is taken for the registry's signature and ignored, as the
        reference ignores it."""
        cohort = _empty_cohort(tree, batches)
        kvecs = []
        for i, (images, client_draws) in enumerate(zip(batches, draws)):
            t, _, kv, loss = moco_local_train(
                cfg, tree, client_state["key_tree"], client_state["queue"],
                images, client_draws, lr)
            cohort.write(i, t, loss)
            kvecs.append(kv)
        return cohort, kvecs

    def finalize(self, cfg: FLConfig, client_state: dict,
                 aggregated_tree: dict, uploads) -> dict:
        """Key encoder := a copy of the aggregated tree; queue := the
        uploads (in order) in front of the old queue, truncated."""
        return {"key_tree": tree_map(torch.clone, aggregated_tree),
                "queue": ssl.fedco_merge_queues(client_state["queue"],
                                                uploads)}


CLIENT_UPDATES = {"dtssl": DTSSLClient(), "fedco": FedCoClient()}
