"""Client update: FLSimCo's dual-temperature SSL — counterpart of
`repro.core.clients` (`_client_loss`, `make_local_train_step`,
`DTSSLClient`).

`DTSSLClient.run_cohort` trains the cohort client by client, as the
reference's ``parallel=False`` path does (the reference pins that path
bitwise equal to its vmapped one); a batched cohort step is later work.
Each client's trained tree is written into its row of the cohort's flat
buffer (core/cohort.py). The loss is the fused DT kernel
(`kernels.ops.dt_loss`); the reference's client differentiates the jnp
`dt_loss_matrix`, which computes the same function.
"""
from __future__ import annotations

import torch

from repro_torch.convert import (flat_spec, leaves_with_paths, tree_map,
                                 unflatten)
from repro_torch.core import ssl
from repro_torch.core.cohort import CohortBatch
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


def local_train(cfg: FLConfig, tree: dict, images: torch.Tensor,
                draws: list, lr: float):
    """cfg.local_iters SGD steps on one client from `tree`; `draws` holds
    one (pi1, pi2) draw pair per iteration. Returns (tree, mean loss)."""
    opt_init, opt_update = sgd(cfg.momentum, cfg.weight_decay)
    opt_state = opt_init(tree["params"])
    losses = []
    for d1, d2 in draws:
        params = tree_map(lambda t: t.detach().requires_grad_(True),
                          tree["params"])
        loss, t2 = client_loss({"params": params, "state": tree["state"]},
                               cfg, images, d1, d2)
        leaves = [leaf for _, leaf in leaves_with_paths(params)]
        grads = unflatten(torch.autograd.grad(loss, leaves), params)
        with torch.no_grad():
            new_params, opt_state = opt_update(
                tree_map(torch.Tensor.detach, params), grads, opt_state, lr)
        tree = {"params": new_params,
                "state": tree_map(torch.Tensor.detach, t2["state"])}
        losses.append(loss.detach())
    return tree, torch.stack(losses).mean()


class DTSSLClient:
    """FLSimCo Step 2: dual-temperature contrastive SSL. Stateless."""

    name = "dtssl"

    def run_cohort(self, cfg: FLConfig, tree: dict, batches: list,
                   draws: list, lr: float) -> CohortBatch:
        """Train each client from `tree` on its batch with its draws;
        returns the cohort with client i's tree in row i."""
        cohort = CohortBatch.empty(flat_spec(tree), len(batches),
                                   device=batches[0].device)
        for i, (images, client_draws) in enumerate(zip(batches, draws)):
            t, loss = local_train(cfg, tree, images, client_draws, lr)
            cohort.write(i, t, loss)
        return cohort


CLIENT_UPDATES = {"dtssl": DTSSLClient()}
