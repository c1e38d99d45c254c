"""The port's ConvNeXt (``models/convnext.py``) against the JAX package's on
the CPU, on weights carried over by ``weights.convnext_state_dict``: the
stage pyramid of a narrow ConvNeXt (depths 1, 1, 2, 1) at 64 x 64, at 72 x
100 (a side that the 2 x 2 / 2 downsampling pads at its end under flax's
``SAME``) and at 70 x 102 (the 4 x 4 / 4 stem pads one row and column on
each side), with the layer scale ``gamma`` drawn U(0.5, 1.5) on both sides;
the classifier head; and the port's seeded random weights, which draw the
alternate trunks' own parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pets_face_recognition_tpu.models import convnext as j_convnext
from pets_face_recognition_tpu_torch import weights
from pets_face_recognition_tpu_torch.models import convnext, rcnn, swin

from test_torch_port_models import rel_err
from test_torch_port_swin import randomize_alt

torch.set_num_threads(1)

NARROW = dict(depths=(1, 1, 2, 1), dims=(8, 16, 24, 32))


def jax_and_port(rng, x, **kw):
    model = j_convnext.ConvNeXt(**kw)
    variables = randomize_alt(jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(x)),
                              rng)
    assert all(0.5 <= g.min() and g.max() <= 1.5 for g in jax.tree_util.tree_leaves(
        {k: v["gamma"] for k, v in variables["params"].items() if "_block" in k}))
    want = jax.jit(model.apply)(variables, jnp.asarray(x))
    port = convnext.ConvNeXt(**kw)
    port.load_state_dict(weights.to_tensors(weights.convnext_state_dict(variables["params"])),
                         strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    return want, got


@pytest.mark.parametrize("hw", [(64, 64), (72, 100), (70, 102)], ids=lambda hw: "%dx%d" % hw)
def test_convnext_pyramid_matches_jax(hw):
    """``c2..c5`` within 1e-4 relative; at 72 x 100 the stage sizes are 18 x
    25, 9 x 13, 5 x 7, 3 x 4, as flax's ``SAME`` gives them."""
    rng = np.random.RandomState(hw[0])
    x = rng.rand(2, *hw, 3).astype(np.float32)
    want, got = jax_and_port(rng, x, features_only=True, **NARROW)
    assert sorted(got) == sorted(want) == ["c2", "c3", "c4", "c5"]
    for k in want:
        g = got[k].permute(0, 2, 3, 1)
        assert g.shape == want[k].shape, k
        assert rel_err(g, want[k]) < 1e-4, k
    if hw == (72, 100):
        assert [tuple(got[k].shape[2:]) for k in sorted(got)] == [(18, 25), (9, 13), (5, 7),
                                                                    (3, 4)]


def test_convnext_classifier_matches_jax():
    """The head: the mean over the last stage, LayerNorm (eps 1e-6), 7
    classes: 1e-4."""
    rng = np.random.RandomState(8)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    want, got = jax_and_port(rng, x, num_classes=7, **NARROW)
    assert got.shape == want.shape == (2, 7)
    assert rel_err(got, want) < 1e-4


@torch.no_grad()
def test_random_weights_draw_the_alternate_trunks_parameters():
    """``weights.init_random_`` on the alternate detectors: LayerNorm weights
    in [0.5, 1.5] with small random biases, ConvNeXt's ``gamma`` in [0.5, 1.5]
    (not 1e-6), Swin's ``pos_embedding`` unit-variance, each seeded."""
    def narrow(trunk):
        det = rcnn.convnext_tiny_keypoint_rcnn() if isinstance(
            trunk, convnext.ConvNeXt) else rcnn.swin_tiny_keypoint_rcnn()
        det.backbone = rcnn._fpn_over(trunk)
        return det

    det = weights.init_random_(narrow(convnext.ConvNeXt(features_only=True, **NARROW)), 3)
    again = weights.init_random_(narrow(convnext.ConvNeXt(features_only=True, **NARROW)), 3)
    assert all(torch.equal(a, b) for a, b in zip(det.state_dict().values(),
                                                 again.state_dict().values()))
    blocks = [m for m in det.modules() if isinstance(m, convnext.ConvNeXtBlock)]
    assert len(blocks) == 5 and all(0.5 <= float(b.gamma.min()) and float(b.gamma.max()) <= 1.5
                                    for b in blocks)
    norms = [m for m in det.modules() if isinstance(m, torch.nn.LayerNorm)]
    assert all(0.5 <= float(n.weight.min()) and float(n.weight.max()) <= 1.5 for n in norms)
    assert all(0 < float(n.bias.abs().max()) < 1 for n in norms)
    sw = weights.init_random_(narrow(swin.SwinTransformer(
        hidden_dim=16, layers=(2, 2, 2, 2), heads=(2, 2, 2, 2), head_dim=8,
        features_only=True)), 4)
    tables = torch.cat([m.pos_embedding.reshape(-1) for m in sw.modules()
                        if isinstance(m, swin.WindowAttention)])
    assert 0.8 < float(tables.std()) < 1.2
