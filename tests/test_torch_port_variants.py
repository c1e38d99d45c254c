"""The dataset-version pipelines ``Preproc7``-``13`` and ``IdentityPreproc``
(counterparts of the JAX ``preprocessor/__init__.py:492-571``), bound to the
keypoint checkpoint variants of ``pipelines.KEYPOINT_VARIANTS`` as
``tests/test_preprocessor.py`` expects of JAX: the variant and the kind
(aligned ``Preproc3`` or box crop ``Preproc6``) of each class, the loader
deferred to first use, an explicit model winning, a variable that names no
checkpoint raising, and two variants loading different weights. The
detector is cut to one block a stage for the checkpoints."""

import atexit
from functools import partial

import numpy as np
import pytest
import torch

from pets_face_recognition_tpu.preprocessor import (
    Preproc7 as JPreproc7, Preproc8 as JPreproc8, Preproc9 as JPreproc9,
    Preproc10 as JPreproc10, Preproc11 as JPreproc11, Preproc12 as JPreproc12,
    Preproc13 as JPreproc13)
from pets_face_recognition_tpu_torch import pipelines, weights
from pets_face_recognition_tpu_torch.models import ptq, rcnn
from pets_face_recognition_tpu_torch.preprocessor import (
    IdentityPreproc, Preproc3, Preproc6, Preproc7, Preproc8, Preproc9, Preproc10, Preproc11,
    Preproc12, Preproc13)

torch.set_num_threads(1)

EXPECTED = {Preproc7: ("v2", True), Preproc8: ("v2", False), Preproc9: ("v3", True),
            Preproc10: ("v3", False), Preproc11: ("v4", True), Preproc12: ("v4", False),
            Preproc13: ("prod", False)}
JAX = {Preproc7: JPreproc7, Preproc8: JPreproc8, Preproc9: JPreproc9, Preproc10: JPreproc10,
       Preproc11: JPreproc11, Preproc12: JPreproc12, Preproc13: JPreproc13}


@pytest.mark.parametrize("cls", list(EXPECTED), ids=lambda c: c.__name__)
def test_variant_pipelines_bind_variant_and_kind(cls):
    variant, aligned = EXPECTED[cls]
    pre = cls(device="cpu")
    assert pre._loader.variant == variant == JAX[cls]()._loader.variant
    assert isinstance(pre, Preproc3 if aligned else Preproc6)
    assert pre._model is None                      # nothing loaded yet
    explicit = torch.nn.Identity()
    assert cls(explicit, device="cpu").model is explicit


def test_variants_match_jax_table():
    import configs.pipelines as cp

    assert {k: v for k, v in pipelines.KEYPOINT_VARIANTS.items()} == cp.KEYPOINT_VARIANTS


def test_deferred_loader_reaches_the_variant(monkeypatch):
    calls = []
    marker = torch.nn.Identity()

    def fake(device, seed=0, variant="prod"):
        calls.append((str(device), variant))
        return marker

    monkeypatch.setattr(pipelines, "keypoint_detector", fake)
    pre = Preproc11(thr=0.5, device="cpu")
    assert not calls
    assert pre.model is marker and pre.model is marker
    assert calls == [("cpu", "v4")] and pre.thr == 0.5


def test_unnamed_variant_checkpoint_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PFR_KEYPOINT_CKPT_V3", str(tmp_path / "nothing"))
    with pytest.raises(FileNotFoundError, match="PFR_KEYPOINT_CKPT_V3"):
        pipelines.keypoint_detector("cpu", variant="v3")
    with pytest.raises(FileNotFoundError, match="PFR_KEYPOINT_CKPT_V3"):
        Preproc9(device="cpu").model
    with pytest.raises(ValueError, match="variant"):
        pipelines.keypoint_detector("cpu", variant="v5")


def _save(folder, seed):
    det = weights.init_random_(rcnn.keypointrcnn_resnet50_fpn(stage_sizes=(1, 1, 1, 1)), seed)
    folder.mkdir(parents=True)
    torch.save({"model": det.state_dict()}, folder / "epoch=0-step=1")
    return det.state_dict()


def test_two_variants_load_different_weights(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    small = partial(rcnn.keypointrcnn_resnet50_fpn, stage_sizes=(1, 1, 1, 1))
    monkeypatch.setattr(rcnn, "keypointrcnn_resnet50_fpn", small)
    v2 = _save(tmp_path / "results" / "keypoint_v2" / "checkpoints", 1)     # the default
    v3 = _save(tmp_path / "v3", 2)
    monkeypatch.setenv("PFR_KEYPOINT_CKPT_V3", str(tmp_path / "v3"))
    got2 = Preproc7(device="cpu").model.state_dict()
    got3 = Preproc10(device="cpu").model.state_dict()
    for got, want in ((got2, v2), (got3, v3)):
        assert all(torch.equal(got[k], want[k]) for k in want)
    key = "backbone.body.conv1.weight"
    assert not torch.equal(got2[key], got3[key])
    # under the quant mode the variant's name is JAX's
    monkeypatch.setenv(ptq.QUANT_MODE_ENV, "calibrate")
    monkeypatch.setenv(ptq.QUANT_COMPONENTS_ENV, "detector,kp_head")
    ptq._REGISTRY.clear()
    try:
        det = pipelines.keypoint_detector("cpu", variant="v3")
        assert isinstance(det, ptq.PTQModelFn) and det.runner.name == "det_keypoint_v3"
        assert torch.equal(det.model.state_dict()[key], v3[key])
    finally:
        ptq._REGISTRY.clear()
        atexit.unregister(ptq.save_quant_state)      # no state written at exit
        ptq._atexit_installed = False


def test_identity_preproc_passes_photos_through():
    img = np.random.RandomState(0).randint(0, 256, (20, 30, 3), np.uint8)
    pre = IdentityPreproc()
    assert pre(img) is img
    out, valid, raw = pre.batch([img, img[:5]])
    assert [o.shape for o in out] == [(20, 30, 3), (5, 30, 3)]
    np.testing.assert_array_equal(out[0], img)
    assert valid.tolist() == [True, True] and raw == {}
