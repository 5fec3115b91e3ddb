"""Client update algorithms, the ``CLIENT_UPDATES`` registry —
counterpart of `repro.core.clients` (`_client_loss`,
`make_local_train_step`, `make_moco_local_train_step`, `DTSSLClient`,
`FedCoClient`).

Every entry has the reference's three hooks, so every topology runs any
client algorithm the same way:

  init_state(cfg, global_tree)          -> client_state (or None)
  run_cohort(cfg, tree, client_state,
             batches, draws, lr)         -> (CohortBatch, uploads)
  finalize(cfg, client_state,
           aggregated_tree, uploads)     -> new client_state

`draws` holds, per client, one (pi1, pi2) draw pair per local iteration
(core/ssl.py). `uploads` is what the vehicles send besides their trees
(FedCo: each client's k-vectors of its last local iteration; DT-SSL:
None). `run_cohort` trains the cohort client by client, as the
reference's ``parallel=False`` path does (the reference pins that path
bitwise equal to its vmapped one); a batched cohort step is later work.
Each client's trained tree is written into its row of the cohort's flat
buffer (core/cohort.py).

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


def _empty_cohort(tree: dict, batches: list) -> CohortBatch:
    return CohortBatch.empty(flat_spec(tree), len(batches),
                             device=batches[0].device)


class DTSSLClient:
    """FLSimCo Step 2: dual-temperature contrastive SSL. Stateless."""

    name = "dtssl"

    def init_state(self, cfg: FLConfig, global_tree: dict):
        return None

    def run_cohort(self, cfg: FLConfig, tree: dict, client_state,
                   batches: list, draws: list, lr: float):
        """Train each client from `tree` on its batch with its draws;
        returns (the cohort with client i's tree in row i, None)."""
        cohort = _empty_cohort(tree, batches)
        for i, (images, client_draws) in enumerate(zip(batches, draws)):
            t, loss = local_train(cfg, tree, images, client_draws, lr)
            cohort.write(i, t, loss)
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
                   batches: list, draws: list, lr: float):
        """Each client from `tree`, the round's key encoder and queue;
        returns (the cohort, each client's k-vectors in cohort order)."""
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
