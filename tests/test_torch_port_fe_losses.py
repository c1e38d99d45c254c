"""The feature extractor's heads and losses in the port (``losses/``) against
the JAX package's on the CPU, on the same weights and inputs: ArcFace (hard
margin on both sides of ``cos θ > cos(π - m)``, easy margin), CosFace, the
focal loss (gamma, per-class ``alpha`` scaling the logits, row weights) and
cross entropy, and ``SoftmaxBasedMetricLearning``'s two calls. Tolerance
1e-6 relative to the largest value (float32); for ArcFace's margin logit, 1e-6
of ``s`` times the formula's sensitivity to ``cos θ`` (``sin θ`` near
``|cos θ| = 1`` multiplies the float32 rounding of ``cos θ`` by ``|cos θ| /
sin θ``, ~20 at 0.9988)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import flax.linen as fnn

from pets_face_recognition_tpu.losses import large_margin as j_lm
from pets_face_recognition_tpu.losses import losses as j_losses
from pets_face_recognition_tpu.losses import SoftmaxBasedMetricLearning as JWrapper
from pets_face_recognition_tpu_torch import losses, weights
from pets_face_recognition_tpu_torch.losses import SoftmaxBasedMetricLearning

torch.set_num_threads(1)

B, D, C = 16, 32, 10


def close(got, want, tol=1e-6):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0), \
        np.abs(got - want).max()


def inputs(seed, spread_cosines=False):
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, D).astype(np.float32)
    weight = rng.randn(C, D).astype(np.float32)
    labels = rng.randint(0, C, B)
    if spread_cosines:
        # rows aligned with, against and across their label's weight, so that
        # cos θ covers both sides of 0 and of cos(π - m)
        for i in range(B):
            w = weight[labels[i]]
            feats[i] = w * np.float32(np.cos(np.pi * i / (B - 1))) + rng.randn(D).astype(
                np.float32) * np.float32(0.05 * (1 + i % 3))
    return feats, weight, labels


@pytest.mark.parametrize("easy_margin", [False, True])
@pytest.mark.parametrize("m", [0.5, 0.2])
def test_arc_margin_matches_jax(easy_margin, m):
    feats, weight, labels = inputs(1, spread_cosines=True)
    j = j_lm.ArcMarginProduct(D, C, s=64.0, m=m, easy_margin=easy_margin)
    cos = np.asarray(j_lm._cosine_logits(jnp.asarray(feats), jnp.asarray(weight)))
    cos_label = cos[np.arange(B), labels]
    assert (cos_label > np.cos(np.pi - m)).any() and (cos_label <= np.cos(np.pi - m)).any()
    assert (cos_label > 0).any() and (cos_label <= 0).any()
    head = losses.ArcMarginProduct(D, C, s=64.0, m=m, easy_margin=easy_margin)
    head.weight.data = torch.from_numpy(weight)
    close(head(torch.from_numpy(feats)), j.apply({"params": {"weight": weight}},
                                                 jnp.asarray(feats)))
    got = head(torch.from_numpy(feats), torch.from_numpy(labels)).detach().numpy()
    want = np.asarray(j.apply({"params": {"weight": weight}}, jnp.asarray(feats),
                              jnp.asarray(labels)))
    sensitivity = np.ones_like(cos)
    sensitivity[np.arange(B), labels] += np.sin(m) * np.abs(cos_label) / np.sqrt(
        np.maximum(1 - cos_label.astype(np.float64) ** 2, 1e-12))
    assert (np.abs(got - want) <= 1e-6 * 64.0 * sensitivity).all(), \
        np.abs(got - want).max()


def test_add_margin_matches_jax():
    feats, weight, labels = inputs(2)
    j = j_lm.AddMarginProduct(D, C, s=30.0, m=0.4)
    head = losses.AddMarginProduct(D, C, s=30.0, m=0.4)
    head.weight.data = torch.from_numpy(weight)
    for lab in (labels, None):
        want = j.apply({"params": {"weight": weight}}, jnp.asarray(feats),
                       None if lab is None else jnp.asarray(lab))
        close(head(torch.from_numpy(feats), None if lab is None else torch.from_numpy(lab)),
              want)


def test_margin_head_init_is_xavier_uniform():
    """The ``(C, D)`` weight, xavier-uniform as flax's ``xavier_uniform()``
    draws it: inside the bound sqrt(6 / (C + D)) and spread over it."""
    head = losses.ArcMarginProduct(512, 1000)
    bound = np.sqrt(6 / 1512)
    w = head.weight.detach().numpy()
    assert w.shape == (1000, 512) and np.abs(w).max() <= bound
    assert abs(w.std() - bound / np.sqrt(3)) < 0.01 * bound
    seeded = weights.init_random_(SoftmaxBasedMetricLearning(torch.nn.Linear(4, 512), 512,
                                                             1000), 0)
    assert np.abs(seeded.add_margin.weight.detach().numpy()).max() <= bound


@pytest.mark.parametrize("gamma", [0.0, 2.0])
@pytest.mark.parametrize("with_alpha", [False, True])
@pytest.mark.parametrize("with_weights", [False, True])
def test_focal_loss_matches_jax(gamma, with_alpha, with_weights):
    rng = np.random.RandomState(3)
    logits = (rng.randn(B, C) * 20).astype(np.float32)
    labels = rng.randint(0, C, B)
    alpha = (rng.rand(C) + 0.5).astype(np.float32) if with_alpha else None
    w = (rng.rand(B) > 0.3).astype(np.float32) if with_weights else None
    want = j_losses.focal_loss(jnp.asarray(logits), jnp.asarray(labels), gamma,
                               None if alpha is None else jnp.asarray(alpha),
                               None if w is None else jnp.asarray(w))
    got = losses.focal_loss(torch.from_numpy(logits), torch.from_numpy(labels), gamma,
                            None if alpha is None else torch.from_numpy(alpha),
                            None if w is None else torch.from_numpy(w))
    close(got, want)
    if gamma == 0.0 and not with_alpha:
        ce = j_losses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                    None if w is None else jnp.asarray(w))
        close(losses.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                   None if w is None else torch.from_numpy(w)), ce)
        close(got, ce)


class _Embed(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = False):
        return fnn.Dense(D, name="fc")(x)


@pytest.mark.parametrize("margin_type,use_focal", [("arc", True), ("add", False)])
def test_metric_learning_wrapper_matches_jax(margin_type, use_focal):
    """``forward(x)`` gives the embeddings; ``forward(x, labels)`` the loss,
    embeddings and margin logits; the head is named ``add_margin``."""
    rng = np.random.RandomState(4)
    x = rng.randn(B, 20).astype(np.float32)
    labels = rng.randint(0, C, B)
    j = JWrapper(model=_Embed(), emb_size=D, num_classes=C, margin_type=margin_type,
                 use_focal=use_focal)
    variables = j.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(labels))
    port = SoftmaxBasedMetricLearning(torch.nn.Linear(20, D), D, C, margin_type=margin_type,
                                      use_focal=use_focal)
    p = variables["params"]
    port.model.weight.data = torch.from_numpy(np.asarray(p["model"]["fc"]["kernel"]).T.copy())
    port.model.bias.data = torch.from_numpy(np.array(p["model"]["fc"]["bias"]))
    port.add_margin.weight.data = torch.from_numpy(np.array(p["add_margin"]["weight"]))
    close(port(torch.from_numpy(x)), j.apply(variables, jnp.asarray(x)))
    got = port(torch.from_numpy(x), torch.from_numpy(labels))
    want = j.apply(variables, jnp.asarray(x), jnp.asarray(labels))
    assert sorted(got) == sorted(want) == ["emb", "logits", "loss"]
    for k in got:
        close(got[k], want[k])
    with pytest.raises(ValueError):
        SoftmaxBasedMetricLearning(torch.nn.Linear(20, D), D, C, margin_type="cos")
