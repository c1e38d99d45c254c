"""The port's float32 entry points, the closed-form inverse of kernel K1 and the
footprint pre-pass of kernel K4, on the CPU.

(a) ``EmbeddingService.embed_batch``, ``KeyPointsController.train_step`` and
``Trainer.fit`` run with TF32 off inside whatever the caller set, through the
legacy ``allow_tf32`` switches or the per-operator ``fp32_precision`` ones, and
give the caller's settings back, also after an exception. Small stand-in
models record the switches their forward sees.
(b) ``invert_homographies`` (the inverse the K1 kernel repeats) against
``torch.linalg.inv`` and the plain warp against the JAX ``warp_perspective``.
(c) ``roi_footprints`` (the plain twin of K4's pre-pass) holds every tap with a
nonzero weight of the plain RoIAlign's ``_taps``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from pets_face_recognition_tpu.ops import homography as j_hom
from pets_face_recognition_tpu_torch.device import float32_flags, float32_matmuls, tf32_flags
from pets_face_recognition_tpu_torch.engine.detector_controller import KeyPointsController
from pets_face_recognition_tpu_torch.engine.trainer import Trainer
from pets_face_recognition_tpu_torch.ops import homography, roi_align
from pets_face_recognition_tpu_torch.serving import EmbeddingService
from pets_face_recognition_tpu_torch.utils import DictWrapper, optim

torch.set_num_threads(1)

BASE = np.array([[70.0, 92.0], [154.0, 92.0], [112.0, 160.0]], np.float32)
STRIDES = (4, 8, 16, 32)
_PER_OP = hasattr(torch.backends.cudnn, "conv")


def _turn_tf32_on(route):
    if route == "legacy":
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    else:
        torch.backends.cudnn.conv.fp32_precision = "tf32"
        torch.backends.cuda.matmul.fp32_precision = "tf32"


@pytest.fixture(params=["legacy", "per-operator"])
def caller_tf32(request):
    """TF32 turned on by the caller through one of torch's two flag APIs; the
    process's own flags come back after the test."""
    if request.param == "per-operator" and not _PER_OP:
        pytest.skip("this torch has no per-operator fp32_precision flags")
    with float32_matmuls():  # restores the flags found here on exit
        _turn_tf32_on(request.param)
        yield tf32_flags()


class _FlagProbe(nn.Module):
    """Records the TF32 switches at every forward; raises when ``fail`` is set."""

    def __init__(self, out):
        super().__init__()
        self.w = nn.Parameter(torch.ones(()))
        self.out = out
        self.seen = []
        self.fail = False

    def forward(self, x, *args, **kwargs):
        self.seen.append(tf32_flags())
        if self.fail:
            raise RuntimeError("probe failure")
        return self.out(self.w, x)


def _service():
    det = _FlagProbe(lambda w, x: {
        "valid": torch.ones(x.shape[0], 1, dtype=torch.bool),
        "scores": torch.ones(x.shape[0], 1),
        "keypoints": torch.tensor([[[[10.0, 10.0, 1.0], [20.0, 10.0, 1.0],
                                     [15.0, 20.0, 1.0]]]]).expand(x.shape[0], 1, 3, 3)})
    emb = _FlagProbe(lambda w, x: x.mean(dim=(1, 2)) * w)
    return EmbeddingService(det, emb, device="cpu"), det, emb


def _controller():
    model = _FlagProbe(lambda w, x: {"loss_a": (w * x).mean()})
    batch = {"images": np.ones((1, 8, 8, 3), np.float32), "boxes": np.zeros((1, 1, 4)),
             "labels": np.zeros((1, 1)), "valid": np.ones((1, 1), bool)}
    config = DictWrapper(dict(model=lambda: model,
                              optimizer=lambda c: optim.detection_sgd_optimizer,
                              train_dataloader=lambda: [batch, batch]))
    ctl = KeyPointsController(config=config)
    state = ctl.init_state(0, "cpu", model=model)
    return ctl, state, batch, model


def test_embed_batch_holds_float32_and_restores_the_callers_flags(caller_tf32):
    service, det, emb = _service()
    service.embed_batch(torch.zeros(2, 32, 32, 3, dtype=torch.uint8),
                        torch.ones(2, dtype=torch.bool))
    assert det.seen == [float32_flags()] and emb.seen == [float32_flags()]
    assert tf32_flags() == caller_tf32
    det.fail = True
    with pytest.raises(RuntimeError, match="probe failure"):
        service.embed_batch(torch.zeros(1, 32, 32, 3, dtype=torch.uint8),
                            torch.ones(1, dtype=torch.bool))
    assert tf32_flags() == caller_tf32


def test_train_step_and_fit_hold_float32_and_restore_the_callers_flags(caller_tf32):
    ctl, state, batch, model = _controller()
    ctl.train_step(state, batch)
    # two steps over the config's two batches, no validation, no checkpoint
    Trainer(max_epochs=1, overfit_batches=2, enable_checkpointing=False,
            device="cpu").fit(ctl, state=state)
    assert model.seen == [float32_flags()] * 3
    assert tf32_flags() == caller_tf32
    model.fail = True
    with pytest.raises(RuntimeError, match="probe failure"):
        ctl.train_step(state, batch)
    assert tf32_flags() == caller_tf32


def test_float32_flags_turn_tf32_off():
    flags = float32_flags()
    assert flags["cudnn.allow_tf32"] is False
    assert flags["float32_matmul_precision"] == "highest"
    assert all(v == "ieee" for k, v in flags.items() if k.endswith("fp32_precision"))
    with float32_matmuls():
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is False


def _alignment_homographies(rng, B, image):
    out = []
    for _ in range(B):
        s = rng.uniform(0.25, 0.45) * image / 224
        th = rng.uniform(-0.3, 0.3)
        R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        c = image / 2 + rng.uniform(-image / 8, image / 8, 2)
        out.append((BASE - BASE.mean(0)) @ R.T * s * 224 / 100 + c)
    lms = torch.from_numpy(np.round(np.asarray(out, np.float32)))
    return homography.alignment_homographies(lms, torch.from_numpy(BASE * image / 320))


@pytest.mark.parametrize("image", [96, 320])
def test_closed_form_inverse_matches_linalg_inv(image):
    Hs = _alignment_homographies(np.random.RandomState(image), 16, image)
    got = homography.invert_homographies(Hs).double()
    want = torch.linalg.inv(Hs.double())
    rel = (got - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)
    assert float(rel.max()) <= 1e-6


def test_warp_with_closed_form_inverse_matches_jax_warp_perspective():
    rng = np.random.RandomState(7)
    imgs = rng.uniform(0, 1, (3, 96, 96, 3)).astype(np.float32)
    Hs = _alignment_homographies(rng, 3, 96)
    got = homography.warp_perspective_batch(torch.from_numpy(imgs), Hs, (48, 48))
    for b in range(3):
        want = np.asarray(j_hom.warp_perspective(jnp.asarray(imgs[b]),
                                                 jnp.asarray(Hs[b].numpy()), (48, 48)))
        # H^-1 from two float32 inverses: the sample positions move by ~1e-5 px
        np.testing.assert_allclose(got[b].numpy(), want, atol=1e-4)


def _footprint_rois(rng, B, per_image, image):
    """Level-spread RoIs: overhanging, 5:1 wide and tall, zero-area, and ones
    whose last samples fall on the last row or column of their level."""
    rois, bidx = [], []
    for b in range(B):
        for i in range(per_image):
            size = 16 * 2 ** rng.uniform(0, 4.5)
            aspect = (5.0, 0.2)[i % 2] if i % 3 == 0 else rng.uniform(0.5, 2.0)
            w, h = size * np.sqrt(aspect), size / np.sqrt(aspect)
            cx, cy = rng.uniform(-20, image + 20, 2)
            rois.append([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2])
            bidx.append(b)
    rois[0] = [30.0, 30.0, 30.0, 40.0]
    rois[1] = [image - 24.0, image - 20.0, image - 0.5, image - 0.25]
    rois[2] = [image - 300.0, image - 8.0, image, image]
    rois[3] = [-50.0, -50.0, -10.0, -10.0]
    return torch.tensor(np.asarray(rois, np.float32)), torch.tensor(bidx, dtype=torch.int32)


@pytest.mark.parametrize("out", [7, 14])
def test_footprints_hold_every_tap_with_a_nonzero_weight(out):
    B, image, C = 2, 128, 4
    shapes = [(B, image // st, image // st, C) for st in STRIDES]
    rois, bidx = _footprint_rois(np.random.RandomState(out), B, 40, image)
    lvl = roi_align.roi_levels(rois, 2, 5)
    fp = roi_align.roi_footprints(shapes, rois, lvl, (out, out), STRIDES, 2)
    assert fp.dtype == torch.int32 and fp.shape == (rois.shape[0], 4)
    idx, wts, oob, P = roi_align._taps(shapes, rois, bidx, (out, out), STRIDES, 2,
                                       224.0, 4, 2, 5)
    offsets = np.cumsum([0] + [h * w for _, h, w, _ in shapes])
    n_taps = 0
    for flat, w in zip(idx, wts):
        for k in range(rois.shape[0]):
            live = ((w[k] > 0) & ~oob[k]).numpy()
            cells = flat[k].numpy()[live] - int(bidx[k]) * P
            l = int(lvl[k])
            assert ((cells >= offsets[l]) & (cells < offsets[l + 1])).all()
            y, x = np.divmod(cells - offsets[l], shapes[l][2])
            y0, y1, x0, x1 = fp[k].tolist()
            assert ((y >= y0) & (y <= y1) & (x >= x0) & (x <= x1)).all(), (k, rois[k])
            n_taps += live.sum()
    assert n_taps > 0
    assert fp[3, 1] == -1  # every sample out of bounds: an empty footprint
    last = torch.tensor([shapes[int(lvl[k])][1] - 1 for k in (1, 2)])
    assert (fp[[1, 2], 1] == last).all()


def test_footprint_keys_on_the_cpu_sort_by_level_and_image():
    B, image = 2, 128
    shapes = [(B, image // st, image // st, 4) for st in STRIDES]
    rois, bidx = _footprint_rois(np.random.RandomState(3), B, 6, image)
    bidx[5] = B  # an image index outside [0, B) goes past every group
    lvl = roi_align.roi_levels(rois, 2, 5)
    key, fp = roi_align.roi_footprints_cuda(shapes, rois, bidx, (7, 7), STRIDES)
    want = lvl.long() * B + bidx.long()
    want[5] = len(shapes) * B
    assert key.dtype == torch.int32 and key.tolist() == want.tolist()
    assert torch.equal(fp, roi_align.roi_footprints(shapes, rois, lvl, (7, 7), STRIDES))
