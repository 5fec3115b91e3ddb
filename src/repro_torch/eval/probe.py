"""Representation-quality evaluation, the paper's Top-1 protocol —
counterpart of `repro.eval.probe` (`encode`, `knn_top1`,
`linear_probe_top1`).

* `encode`: frozen-encoder features (pre-projector 512-D by default),
  L2-normalized.
* `knn_top1`: weighted kNN on the normalized features (k = 20, tau =
  0.1), the usual contrastive-learning monitor; `knn_votes` gives each
  test point's class votes.
* `linear_probe_top1`: one linear layer trained on frozen features with
  SGD, closer to the paper's fine-tune-then-classify setting;
  `linear_probe_fit` returns the trained layer.

Each runs on the card unless ``device="cpu"`` is passed. Features travel
as numpy arrays, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.convert import tree_map
from repro_torch.models.resnet import resnet_apply
from repro_torch.runtime import resolve_device


def encode(tree: dict, images, batch: int = 256, use_projector: bool = False,
           device=None) -> np.ndarray:
    """(N, H, W, 3) images -> (N, 512) features (the 128-D projector
    output with `use_projector`), L2-normalized with max(norm, 1e-8)."""
    device = resolve_device(device)
    tree = tree_map(lambda t: t.to(device), tree)
    outs = []
    with torch.no_grad():
        for i in range(0, len(images), batch):
            x = torch.as_tensor(np.asarray(images[i:i + batch]),
                                device=device)
            z, h, _ = resnet_apply(tree, x, train=False)
            outs.append((z if use_projector else h).cpu().numpy())
    f = np.concatenate(outs)
    return f / np.maximum(np.linalg.norm(f, axis=-1, keepdims=True), 1e-8)


def knn_votes(train_feats, train_labels, test_feats, k: int = 20,
              tau: float = 0.1, device=None) -> torch.Tensor:
    """(N_test, C) float64 class votes of the weighted kNN (Wu et al.
    protocol): each test point's k nearest training points vote with
    exp(sim / tau) for their class, in batches of 512 test points."""
    device = resolve_device(device)
    train = torch.as_tensor(np.asarray(train_feats), device=device)
    labels = torch.as_tensor(np.asarray(train_labels), device=device).long()
    test = torch.as_tensor(np.asarray(test_feats), device=device)
    n_classes = int(labels.max()) + 1
    out = []
    for i in range(0, len(test), 512):
        sims = test[i:i + 512] @ train.T                         # (b, N)
        top, idx = torch.topk(sims, k, dim=1)
        w = torch.exp(top / tau).double()
        out.append(torch.zeros((len(top), n_classes), dtype=torch.float64,
                               device=device).scatter_add_(1, labels[idx], w))
    return torch.cat(out)


def knn_top1(train_feats, train_labels, test_feats, test_labels,
             k: int = 20, tau: float = 0.1, device=None) -> float:
    """Weighted-kNN Top-1 accuracy: the class with the most `knn_votes`."""
    pred = knn_votes(train_feats, train_labels, test_feats, k, tau,
                     device).argmax(dim=1).cpu().numpy()
    return float((pred == np.asarray(test_labels)).sum()) / len(test_feats)


def linear_probe_fit(train_feats, train_labels, epochs: int = 20,
                     lr: float = 0.5, seed: int = 0, device=None):
    """A zero-initialised linear classifier (W (D, C), b (C,)) trained on
    frozen features with softmax cross-entropy: batches of 512 in a
    `RandomState(seed)` permutation each epoch, lr halved every 8
    epochs."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    x = torch.as_tensor(np.asarray(train_feats), device=device)
    y = torch.as_tensor(np.asarray(train_labels), device=device).long()
    n_classes = int(y.max()) + 1
    W = torch.zeros((x.shape[1], n_classes), dtype=torch.float32,
                    device=device)
    b = torch.zeros(n_classes, dtype=torch.float32, device=device)
    bs = 512
    for e in range(epochs):
        perm = rng.permutation(len(x))
        step_lr = lr * (0.5 ** (e // 8))
        for i in range(0, len(x), bs):
            idx = torch.from_numpy(perm[i:i + bs]).to(device)
            Wg, bg = W.requires_grad_(True), b.requires_grad_(True)
            logits = x[idx] @ Wg + bg
            loss = -torch.log_softmax(logits, dim=-1)[
                torch.arange(len(idx), device=device), y[idx]].mean()
            gW, gb = torch.autograd.grad(loss, (Wg, bg))
            with torch.no_grad():
                W = W.detach() - step_lr * gW
                b = b.detach() - step_lr * gb
    return W.detach(), b.detach()


def linear_probe_top1(train_feats, train_labels, test_feats, test_labels,
                      epochs: int = 20, lr: float = 0.5, seed: int = 0,
                      device=None) -> float:
    """Test Top-1 of `linear_probe_fit`'s classifier."""
    W, b = linear_probe_fit(train_feats, train_labels, epochs, lr, seed,
                            device)
    test = torch.as_tensor(np.asarray(test_feats), device=W.device)
    pred = (test @ W + b).argmax(dim=1).cpu().numpy()
    return float((pred == np.asarray(test_labels)).mean())
