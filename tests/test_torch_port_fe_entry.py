"""The port's feature-extractor entry points on the CPU, on a ``make_fe``
miniature (10 identities of 4 crops of 64 x 64; 5 training identities, B =
8, 2 steps an epoch) with the embedder cut to one block a stage:
``build_fe_config`` -> ``configure_trainer(...).fit`` for 2 epochs with
validation and checkpoints, a resume into a third epoch, ``main`` in its own
process and ``eval_fe`` on its checkpoint (also without the margin head), and
``transform_dataset``'s command line."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pets_face_recognition_tpu_torch import eval_fe, smoke_data, transform_dataset
from pets_face_recognition_tpu_torch.engine.checkpoint import load_checkpoint
from pets_face_recognition_tpu_torch.engine.controller import Controller
from pets_face_recognition_tpu_torch.engine.logging import MetricsLogger
from pets_face_recognition_tpu_torch.engine.trainer import configure_trainer
from pets_face_recognition_tpu_torch.utils import get_config

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

CONFIG = """from pets_face_recognition_tpu_torch.config_presets import build_fe_config
from pets_face_recognition_tpu_torch.models.embedder import resnet50_embedder

globals().update(build_fe_config(dataset_dir={data!r}, n_epochs={epochs}, train_batch_size=8,
                                 test_batch_size=8, crop=60, size=64, num_workers=2,
                                 output={out!r}, n_pairs=40, optimizer_kind={kind!r}))
img_dir = {img!r}


def model():
    return resnet50_embedder(512, stage_sizes=(1, 1, 1, 1))
"""


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("fe_entry")
    smoke_data.make_fe(root, n_ids=10, n_imgs=4, size=64)
    return root


def write_config(root: Path, name: str, epochs: int = 2, kind: str = "sgd") -> Path:
    out = root / name
    out.mkdir()
    path = out / "fe_config.py"
    path.write_text(CONFIG.format(data=str(root / "smoke_fe_cats"), epochs=epochs,
                                  out=str(out), kind=kind, img=str(out / "img")))
    return path


def test_fit_checkpoints_and_resume(corpus):
    """2 epochs of 2 steps: finite losses and accuracies in the log, the
    validation metrics each epoch, ``epoch=0-step=2`` and ``epoch=1-step=4``,
    the eval JSON in ``img_dir``; a 3-epoch trainer resumes at epoch 2, step
    4, from a bit-equal state."""
    config = get_config(write_config(corpus, "fit"))
    root = Path(config.output)
    trainer = configure_trainer(config, MetricsLogger(root / "log"), device="cpu")
    state = trainer.fit(Controller(config))
    assert state.step == 4
    assert sorted(p.name for p in (root / "checkpoints").iterdir()) == [
        "epoch=0-step=2", "epoch=1-step=4"]
    recs = [json.loads(x) for x in (root / "log" / "metrics.jsonl").read_text().splitlines()]
    epochs = [r for r in recs if "epoch_time_s" in r]
    assert len(epochs) == 2 and all(np.isfinite(r["epoch_loss"]) for r in epochs)
    assert all(r["data_time_s"] >= 0 and r["step_time_s"] > 0 for r in epochs)
    val = [r for r in recs if "val Val ROC AUC" in r]
    assert len(val) == 2 and all("val Val Recall@K=5" in r for r in val)
    dump = json.loads((root / "img" / "eval_1.json").read_text())["Val"]
    assert set(dump) == {"opt_thr", "roc_auc", "confusion", "roc"}

    saved = {k: v.clone() for k, v in state.model.state_dict().items()}
    resumed = configure_trainer(config, MetricsLogger(root / "log2"), device="cpu",
                                max_epochs=3)
    ctl = Controller(config)
    fresh = ctl.init_state(0, "cpu")
    from pets_face_recognition_tpu_torch.engine.checkpoint import restore_checkpoint
    assert restore_checkpoint(fresh, root / "checkpoints" / "epoch=1-step=4") == 1
    assert all(torch.equal(v, saved[k]) for k, v in fresh.model.state_dict().items())
    assert fresh.step == 4 and len(fresh.optimizer.param_groups) == 3
    assert [g["lr_scale"] for g in fresh.optimizer.param_groups] == [0.5, 1.0, 1.0]
    out = resumed.fit(ctl)
    assert resumed.start_epoch == 2 and out.step == 6
    assert (root / "checkpoints" / "epoch=2-step=6").exists()


def test_adamw_fit_one_epoch(corpus):
    config = get_config(write_config(corpus, "adamw", epochs=1, kind="adamw"))
    trainer = configure_trainer(config, MetricsLogger(Path(config.output) / "log"),
                                device="cpu")
    state = trainer.fit(Controller(config))
    assert isinstance(state.optimizer, torch.optim.AdamW) and state.step == 2
    assert all(torch.isfinite(p).all() for p in state.model.parameters())


def test_main_and_eval_fe_exit_0(corpus, tmp_path):
    """``python -m pets_face_recognition_tpu_torch.main --config ... --device
    cpu`` exits 0 with a checkpoint; ``eval_fe`` evaluates it (and the same
    weights without ``add_margin``, a non-strict merge) to the same metrics."""
    cfg = write_config(corpus, "main", epochs=1)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "pets_face_recognition_tpu_torch.main",
                           "--config", str(cfg), "--device", "cpu"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "Completed!" in proc.stdout, proc.stderr[-2000:]
    ckpts = list((corpus / "main").glob("*/checkpoints/epoch=0-step=2"))
    assert len(ckpts) == 1
    metrics = eval_fe.main(["--config", str(cfg), "--ckpt", str(ckpts[0].parent),
                            "--device", "cpu"])
    assert list(metrics) == ["Val"] and 0.0 <= metrics["Val"]["ROC AUC"] <= 1.0
    payload = load_checkpoint(ckpts[0])
    payload["model"] = {k: v for k, v in payload["model"].items() if "add_margin" not in k}
    torch.save(payload, tmp_path / "no_margin")
    again = eval_fe.evaluate(cfg, tmp_path / "no_margin", device="cpu")
    assert again == metrics
    with pytest.raises(SystemExit):
        eval_fe.main(["--help"])


def test_transform_dataset_cli(tmp_path, monkeypatch, capsys):
    """``transform_dataset --pipeline head --thr 0`` over a ``make_data25``
    folder with random full-width weights (no checkpoint at the default
    place): photos written under their own relative names; a
    ``PFR_KEYPOINT_CKPT`` naming no checkpoint raises."""
    smoke_data.make_data25(tmp_path, n_cards=2, n_imgs=1)
    monkeypatch.setenv("PFR_KEYPOINT_CKPT", str(tmp_path / "no_checkpoint"))
    with pytest.raises(FileNotFoundError):
        transform_dataset.main(["--input", str(tmp_path), "--output", str(tmp_path / "o"),
                                "--device", "cpu"])
    monkeypatch.delenv("PFR_KEYPOINT_CKPT")
    monkeypatch.chdir(tmp_path)               # no results/keypoint/checkpoints here
    written = transform_dataset.main(["--input", str(tmp_path / "data_25"), "--output",
                                      str(tmp_path / "out"), "--thr", "0.0", "--batch-size",
                                      "4", "--device", "cpu"])
    names = sorted(str(p.relative_to(tmp_path / "out")) for p in written)
    photos = sorted(str(p.relative_to(tmp_path / "data_25"))
                    for p in (tmp_path / "data_25").glob("*/*.jpg"))
    assert set(names) <= set(photos) and names
    assert "wrote" in capsys.readouterr().out


def test_keypoint_detector_checkpoint_route(tmp_path, monkeypatch):
    """``PFR_KEYPOINT_CKPT`` naming a folder of port checkpoints: the newest
    ``epoch=*-step=*`` is loaded strictly into the ResNet-50-FPN detector,
    which keeps ``RCNNConfig``'s test budgets (1000 proposals a level into
    the RPN's NMS, 1000 out), not the serving detector's 128 and 16."""
    from pets_face_recognition_tpu_torch.models.rcnn import RCNNConfig
    from pets_face_recognition_tpu_torch.pipelines import keypoint_detector
    from pets_face_recognition_tpu_torch.serving import serving_detector

    state = serving_detector("cpu", seed=4).state_dict()
    ckpts = tmp_path / "checkpoints"
    ckpts.mkdir()
    torch.save({"model": state}, ckpts / "epoch=1-step=6")
    torch.save({"model": {k: torch.zeros_like(v) for k, v in state.items()}},
               ckpts / "epoch=0-step=3")
    monkeypatch.setenv("PFR_KEYPOINT_CKPT", str(ckpts))
    monkeypatch.delenv("PFR_KEYPOINT_ARCH", raising=False)
    det = keypoint_detector("cpu")
    assert not det.training
    assert all(torch.equal(v, state[k]) for k, v in det.state_dict().items())
    assert (det.cfg.rpn_pre_nms_top_n_test, det.cfg.rpn_post_nms_top_n_test) == (
        RCNNConfig.rpn_pre_nms_top_n_test, RCNNConfig.rpn_post_nms_top_n_test) == (1000, 1000)
