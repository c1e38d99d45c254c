"""Mask R-CNN's training and evaluation entry points in-process on the CPU
(``--device cpu``): ``main_detection`` trains from a config over a seeded
Oxford-IIIT Pet miniature (``smoke_data.make_oxford``) and writes its run
directory and checkpoint; ``eval_detection`` restores the newest checkpoint
of that run and gives the run's own last validation metrics; both default to
CUDA and raise without it. The committed smoke config builds the JAX smoke
recipe's loaders over the miniature it writes under ``PFR_SMOKE_ROOT``."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pets_face_recognition_tpu_torch import eval_detection, main_detection
from pets_face_recognition_tpu_torch.engine.detector_controller import DetectionController
from pets_face_recognition_tpu_torch.main import main
from pets_face_recognition_tpu_torch.smoke_data import make_oxford
from pets_face_recognition_tpu_torch.utils import get_config

torch.set_num_threads(1)

PORT = Path(__file__).resolve().parent.parent / "pets_face_recognition_tpu_torch"
CONFIG = '''
from pets_face_recognition_tpu_torch.config_presets import build_mask_config
from pets_face_recognition_tpu_torch.models.rcnn import maskrcnn_resnet50_fpn

globals().update(build_mask_config(
    data_root={data!r}, n_epochs=1, train_batch_size=2, test_batch_size=2,
    image_size=(64, 64), max_boxes=2, num_workers=2, output={out!r}))


def model():
    return maskrcnn_resnet50_fpn(
        stage_sizes=(1, 1, 1, 1), rpn_pre_nms_top_n_train=32, rpn_post_nms_top_n_train=16,
        box_batch_size_per_image=8, rpn_pre_nms_top_n_test=64, rpn_post_nms_top_n_test=16)


trainer_kwargs = {{"limit_train_batches": 1, "log_every_n_steps": 1}}
'''


def test_main_detection_trains_and_eval_detection_evaluates(tmp_path):
    make_oxford(tmp_path / "data", n_imgs=10, size=96)
    cfg = tmp_path / "tiny_mask.py"
    cfg.write_text(CONFIG.format(data=str(tmp_path / "data"), out=str(tmp_path / "out")))
    trainer = main(DetectionController, ["--config", str(cfg), "--device", "cpu"])
    (run,) = (tmp_path / "out").iterdir()
    assert sorted(p.name for p in run.iterdir()) == ["checkpoints", "img", "metrics.jsonl",
                                                     "params.json", cfg.name]
    assert [p.name for p in (run / "checkpoints").iterdir()] == ["epoch=0-step=1"]
    assert trainer.state.step == 1 and next(trainer.state.model.parameters()).device.type == "cpu"
    recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert any("loss_mask" in k for r in recs for k in r)
    val = recs[-1]

    got = eval_detection.main(["--config", str(cfg), "--ckpt", str(run / "checkpoints"),
                               "--device", "cpu"])
    assert list(got) == ["val"] and list(got["val"]) == [
        "Mean IoU", "Median IoU", "AP 50", "AP 70", "AP 90", "Masks Mean IoU"]
    # the same weights on the same validation batch (both photos)
    assert {f"val val {k}": v for k, v in got["val"].items()} == pytest.approx(
        {k: v for k, v in val.items() if k.startswith("val ")}, nan_ok=True)


def test_mask_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(main_detection.DetectionController, ["--config", str(PORT)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_detection.main(["--ckpt", str(PORT)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DetectionController().init_state(0, model=torch.nn.Linear(1, 1))
    assert eval_detection.DEFAULT_CONFIG.name == "mask_rcnn_config.py"


def test_smoke_config_builds_the_jax_smoke_recipe(monkeypatch, tmp_path):
    """``configs/mask_smoke.py`` writes the 40-photo miniature under
    ``PFR_SMOKE_ROOT`` and splits it 32 / 8: 8 training batches of 4 at
    320 x 320 with 2 box slots and their masks, 2 validation batches; the
    production model."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PFR_SMOKE_ROOT", str(tmp_path / "oxford"))
    config = get_config(PORT / "configs" / "mask_smoke.py")
    assert (tmp_path / "oxford" / "oxford-iiit-pet" / "annotations" / "trainval.txt").exists()
    train, val = config.train_dataloader(), config.val_dataloader()
    assert (len(train), len(val), config.n_epochs) == (8, 2, 1)
    batch = next(iter(val))
    assert batch["images"].shape == (4, 320, 320, 3) and batch["masks"].shape == (4, 2, 320, 320)
    assert batch["valid"][:, 0].all() and not batch["valid"][:, 1].any()
    assert set(np.unique(batch["masks"])) == {0.0, 1.0}    # 320 -> 320: no resize
    m = config.model()
    assert m.cfg.with_mask and m.cfg.box_detections_per_img == 3
    assert m.cfg.rpn_post_nms_top_n_train == 2000 and (tmp_path / "results_smoke").is_dir()
