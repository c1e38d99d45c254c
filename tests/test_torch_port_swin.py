"""The port's Swin Transformer (``models/swin.py``) against the JAX package's
on the CPU, on weights carried over by ``weights.swin_state_dict``: the stage
pyramid of a narrow Swin on non-square 64 x 128 images with the relative
position bias and with the dense one, a shifted block alone, the classifier
head, a reference-layout (berniwal) state dict that loads ``strict=True``
into the port and through JAX's ``convert_swin`` gives the same outputs, and
the ``ValueError`` on an input the windows do not tile.

A non-square input tells the window order ``(nh nw)`` apart from ``(nw nh)``:
the shifted blocks' masks go to the bottom row and the rightmost column of
windows. Float32; relative tolerances on the largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pets_face_recognition_tpu.models import swin as j_swin
from pets_face_recognition_tpu.utils.torch_convert import convert_swin
from pets_face_recognition_tpu_torch import weights
from pets_face_recognition_tpu_torch.models import swin

from test_torch_port_models import randomize, rel_err

torch.set_num_threads(1)

NARROW = dict(hidden_dim=16, layers=(2, 2, 2, 2), heads=(2, 2, 2, 2), head_dim=8,
              window_size=4, downscaling_factors=(2, 2, 2, 2))


def randomize_alt(tree, rng):
    """``randomize`` with the alternate trunks' own draws: Swin's
    ``pos_embedding`` N(0, 1), as flax initialises it, and ConvNeXt's layer
    scale ``gamma`` U(0.5, 1.5) (flax's 1e-6 would make every block the
    identity to float32 precision)."""
    tree = randomize(tree, rng)

    def leaf(path, x):
        name = path[-1].key
        if name == "gamma":
            return (rng.rand(*x.shape) + 0.5).astype(np.float32)
        if name == "pos_embedding":
            return rng.randn(*x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, tree)


def jax_and_port(rng, x, **kw):
    """A JAX ``SwinTransformer`` with random variables, its outputs on ``x``
    (NHWC), and the port's twin loaded from them."""
    model = j_swin.SwinTransformer(**kw)
    variables = randomize_alt(jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(x)),
                              rng)
    want = jax.jit(model.apply)(variables, jnp.asarray(x))
    port = swin.SwinTransformer(**kw)
    port.load_state_dict(weights.to_tensors(weights.swin_state_dict(variables["params"])),
                         strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    return variables, want, got


@pytest.mark.parametrize("relative", [True, False], ids=["relative_bias", "dense_bias"])
def test_swin_pyramid_matches_jax_on_non_square_input(relative):
    """``c2..c5`` of a narrow Swin (widths 16..128, window 4, downscaling 2 a
    stage) on 2 images of 64 x 128: 1e-4 relative, with the relative bias
    table ``(2w - 1, 2w - 1)`` and with the dense ``(w², w²)`` one."""
    rng = np.random.RandomState(1 + relative)
    x = rng.rand(2, 64, 128, 3).astype(np.float32)
    _, want, got = jax_and_port(rng, x, features_only=True, relative_pos_embedding=relative,
                                **NARROW)
    assert sorted(got) == sorted(want) == ["c2", "c3", "c4", "c5"]
    for k in want:
        g = got[k].permute(0, 2, 3, 1)
        assert g.shape == want[k].shape, k
        assert rel_err(g, want[k]) < 1e-4, k


def test_shifted_block_matches_jax():
    """One ``SwinBlock(shifted=True)`` on a 2 x 8 x 12 token map (window 4: 2
    x 3 windows, so the masked bottom row and right column differ): 1e-5."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 12, 16).astype(np.float32)
    block = j_swin.SwinBlock(16, 2, 8, 64, shifted=True, window_size=4)
    variables = randomize_alt(jax.eval_shape(block.init, jax.random.PRNGKey(0), jnp.asarray(x)),
                              rng)
    want = jax.jit(block.apply)(variables, jnp.asarray(x))
    p = variables["params"]
    port = swin.SwinBlock(16, 2, 8, 64, shifted=True, window_size=4)
    sd = weights.swin_state_dict({"stage1": {"patch_partition": {"linear": {
        "kernel": np.zeros((3, 16), np.float32), "bias": np.zeros(16, np.float32)}},
        "block0_shifted": p}})
    prefix = "stage1.layers.0.1."
    port.load_state_dict(weights.to_tensors({k[len(prefix):]: v for k, v in sd.items()
                                             if k.startswith(prefix)}), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert rel_err(got, want) < 1e-5


def test_swin_classifier_matches_jax():
    """The head: the mean over the last stage, LayerNorm (eps 1e-6) and the
    classifier, 5 classes: 1e-4."""
    rng = np.random.RandomState(4)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    _, want, got = jax_and_port(rng, x, num_classes=5, **NARROW)
    assert got.shape == want.shape == (2, 5)
    assert rel_err(got, want) < 1e-4


def test_reference_state_dict_loads_strict_and_matches_convert_swin():
    """A random state dict in the reference's (berniwal) layout, with the
    two masks its shifted blocks store (``-inf`` entries), loads into the
    port with ``strict=True``; JAX's ``convert_swin`` of the same dict gives
    the same logits (1e-4), and ``swin_state_dict`` inverts ``convert_swin``
    exactly. A stored mask that masks other entries is refused."""
    rng = np.random.RandomState(5)
    port = swin.SwinTransformer(num_classes=3, **NARROW)
    ref = {k: rng.randn(*v.shape).astype(np.float32) * 0.3 for k, v in port.state_dict().items()}
    masks = {}
    for name, m in port.named_modules():
        if isinstance(m, swin.WindowAttention) and m.shifted:
            ul, lr = swin.shift_masks(m.window_size, m.window_size // 2)
            masks[f"{name}.upper_lower_mask"] = np.where(ul < 0, -np.inf, 0).astype(np.float32)
            masks[f"{name}.left_right_mask"] = np.where(lr < 0, -np.inf, 0).astype(np.float32)
    assert len(masks) == 2 * 4          # one shifted block a stage
    port.load_state_dict(weights.to_tensors({**ref, **masks}), strict=True)

    params = convert_swin({**ref, **masks})
    back = weights.swin_state_dict(params)
    assert sorted(back) == sorted(ref)
    assert all(np.array_equal(back[k], ref[k]) for k in ref)

    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    want = jax.jit(j_swin.SwinTransformer(num_classes=3, **NARROW).apply)({"params": params},
                                                                          jnp.asarray(x))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert rel_err(got, want) < 1e-4

    wrong = dict(masks)
    key = next(iter(wrong))
    wrong[key] = np.zeros_like(wrong[key])
    with pytest.raises(ValueError, match="masks other entries"):
        port.load_state_dict(weights.to_tensors({**ref, **wrong}), strict=True)


def test_indivisible_input_raises_value_error():
    """H and W must be multiples of ``window_size x prod(downscaling_factors)``:
    the error names the input and that number (JAX fails inside ``rearrange``)."""
    port = swin.SwinTransformer(features_only=True, **NARROW)
    with pytest.raises(ValueError, match=r"64 x 96.*= 64"):
        port(torch.zeros(1, 3, 64, 96))
    assert swin.swin_t(features_only=True).divisor == 224
