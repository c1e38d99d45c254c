"""The port's training and evaluation entry points in-process on the CPU
(``--device cpu``): ``main_keypoints`` trains from a config over the
committed CAT miniature and writes its run directory as the JAX ``main.py``
does; ``eval_landmark`` evaluates the newest checkpoint of that run and gives
the run's own last validation metrics. The committed smoke config builds the
JAX smoke recipe's loaders over the miniature."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pets_face_recognition_tpu_torch import eval_landmark
from pets_face_recognition_tpu_torch.engine.detector_controller import KeyPointsController
from pets_face_recognition_tpu_torch.main_keypoints import main
from pets_face_recognition_tpu_torch.utils import get_config

torch.set_num_threads(1)

PORT = Path(__file__).resolve().parent.parent / "pets_face_recognition_tpu_torch"
CONFIG = '''
from pets_face_recognition_tpu_torch.config_presets import build_keypoint_config
from pets_face_recognition_tpu_torch.models.rcnn import keypointrcnn_resnet50_fpn

globals().update(build_keypoint_config(
    data_root={data!r}, n_epochs=1, train_batch_size=2, test_batch_size=8,
    image_size=(64, 64), max_boxes=2, num_workers=2, output={out!r}))


def model():
    return keypointrcnn_resnet50_fpn(
        stage_sizes=(1, 1, 1, 1), rpn_pre_nms_top_n_train=32, rpn_post_nms_top_n_train=16,
        box_batch_size_per_image=4, rpn_pre_nms_top_n_test=64, rpn_post_nms_top_n_test=16)


trainer_kwargs = {{"limit_train_batches": 1, "log_every_n_steps": 1}}
'''


def test_main_keypoints_trains_and_eval_landmark_evaluates(tmp_path):
    cfg = tmp_path / "tiny_keypoints.py"
    cfg.write_text(CONFIG.format(data=str(PORT / "testdata"), out=str(tmp_path / "out")))
    trainer = main(KeyPointsController, ["--config", str(cfg), "--device", "cpu"])
    (run,) = (tmp_path / "out").iterdir()
    assert sorted(p.name for p in run.iterdir()) == ["checkpoints", "img", "metrics.jsonl",
                                                     "params.json", cfg.name]
    assert [p.name for p in (run / "checkpoints").iterdir()] == ["epoch=0-step=1"]
    assert "model" in json.loads((run / "params.json").read_text())
    assert trainer.state.step == 1 and next(trainer.state.model.parameters()).device.type == "cpu"
    val = json.loads((run / "metrics.jsonl").read_text().splitlines()[-1])

    got = eval_landmark.main(["--config", str(cfg), "--ckpt", str(run / "checkpoints"),
                              "--device", "cpu"])
    assert list(got) == ["val"] and {"AP 50", "AP 70", "Mean IoU"} <= set(got["val"])
    # the same weights on the same validation batch (all 8 photos)
    assert {f"val val {k}": v for k, v in got["val"].items()} == pytest.approx(
        {k: v for k, v in val.items() if k.startswith("val ")}, nan_ok=True)
    with pytest.raises(FileNotFoundError, match="no epoch"):
        eval_landmark.resolve_checkpoint(tmp_path)


def test_smoke_config_builds_the_jax_smoke_recipe_over_the_miniature(monkeypatch, tmp_path):
    """40 photos split 32 / 8: 8 training batches of 4 at 320 x 320 with 2
    box slots and 3 keypoints, 2 validation batches."""
    monkeypatch.chdir(tmp_path)
    config = get_config(PORT / "configs" / "keypoint_smoke.py")
    train, val = config.train_dataloader(), config.val_dataloader()
    assert (len(train), len(val), config.n_epochs) == (8, 2, 1)
    batch = next(iter(val))
    assert batch["images"].shape == (4, 320, 320, 3) and batch["images"].dtype == np.float32
    assert batch["keypoints"].shape == (4, 2, 3, 3) and batch["valid"][:, 0].all()
    assert not batch["valid"][:, 1].any() and (tmp_path / "results_smoke").is_dir()
    assert config.model().cfg.rpn_post_nms_top_n_train == 2000
