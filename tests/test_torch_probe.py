"""The port's probe (repro_torch.eval.probe) and Fig.-6 statistic
(repro_torch.core.federation.gradient_std) against the reference's, on
the CPU."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core.federation import gradient_std as j_gradient_std
from repro.eval import probe as jprobe
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.federation import gradient_std
from repro_torch.eval import probe as tprobe
from repro_torch.models.resnet import init_resnet
from test_torch_round import torch_threads  # noqa: F401 (autouse)

# Frozen-encoder features through two frameworks' float32 convolutions
# and BN (inference statistics), then normalized. Measured: max abs
# 1.6e-7 (512-D) and 3.0e-7 (128-D projector).
FEAT_TOL = 2e-6


@pytest.fixture(scope="module")
def tree():
    """A ResNet-18-CIFAR tree with random weights, as numpy leaves."""
    return convert.tree_to_numpy(init_resnet(
        get_config("resnet18-cifar"), torch.Generator().manual_seed(0),
        "cpu"))


@pytest.mark.parametrize("use_projector", [False, True])
def test_encode_matches_reference(tree, use_projector):
    images = np.random.RandomState(0).rand(20, 16, 16, 3).astype(np.float32)
    want = jprobe.encode(tree, images, batch=8, use_projector=use_projector)
    got = tprobe.encode(convert.tree_from_numpy(tree), images, batch=8,
                        use_projector=use_projector, device="cpu")
    assert got.shape == want.shape == (20, 128 if use_projector else 512)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=FEAT_TOL)


def _features(seed, n_train=700, n_test=600, classes=10, dim=64):
    """Class-clustered unit features: separable enough that Top-1 is far
    from both chance and 1."""
    rs = np.random.RandomState(seed)
    centers = rs.randn(classes, dim)

    def draw(n):
        y = rs.randint(0, classes, n)
        x = (centers[y] * 0.35 + rs.randn(n, dim)).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True), y
    return (*draw(n_train), *draw(n_test))


@pytest.mark.parametrize("seed", [0, 1])
def test_knn_and_linear_probe_equal_reference(seed):
    f_tr, y_tr, f_te, y_te = _features(seed)
    knn = tprobe.knn_top1(f_tr, y_tr, f_te, y_te, device="cpu")
    assert knn == jprobe.knn_top1(f_tr, y_tr, f_te, y_te)
    lin = tprobe.linear_probe_top1(f_tr, y_tr, f_te, y_te, epochs=10,
                                   device="cpu")
    assert lin == jprobe.linear_probe_top1(f_tr, y_tr, f_te, y_te,
                                           epochs=10)
    assert 0.2 < knn < 0.95 and 0.2 < lin < 0.95


def test_gradient_std_equals_reference():
    losses = np.random.RandomState(2).rand(40) * 3
    assert gradient_std(losses) == j_gradient_std(losses)
    assert gradient_std(list(losses)) == j_gradient_std(list(losses))
