"""Precise BN and the MobileNetV3 smoke recipe against the JAX tools on the
CPU: ``recalibrate_bn`` on a port checkpoint and the JAX
``tools/recalibrate_bn.py`` on an orbax checkpoint of the same random
variables (carried over with ``weights.detection_state_dict``), and
``configs/keypoint_mobile_smoke.py`` against JAX's
``configs/smoke/keypoint_mobile_smoke.py``.

Both tools run 3 train-mode trunk passes of B = 2 over the committed CAT
miniature at 320 x 320, the photos' own size, where the two collates give
the same pixels; at a resized size they differ by up to one level of 255
(cv2's fixed-point resize against ``F.interpolate``, held by
``test_torch_port_det_data.py``), which random weights amplify through the
trunk's 15 blocks.
"""

import importlib
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from pets_face_recognition_tpu.engine.checkpoint import load_checkpoint as j_load_checkpoint
from pets_face_recognition_tpu.models import rcnn as j_rcnn
from pets_face_recognition_tpu.utils import get_dict_wrapper
from pets_face_recognition_tpu_torch import recalibrate_bn, weights
from pets_face_recognition_tpu_torch.engine.checkpoint import latest_checkpoint
from pets_face_recognition_tpu_torch.models.resnet import LiveBatchNorm2d
from pets_face_recognition_tpu_torch.utils import get_config

from test_torch_port_models import randomize

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "pets_face_recognition_tpu_torch"
CAT = PORT / "testdata" / "CAT_DATASET"
sys.path.insert(0, str(REPO / "tools"))
j_tool = importlib.import_module("recalibrate_bn")

torch.set_num_threads(1)

ARGS = ["--data", str(CAT), "--passes", "3", "--batch", "2", "--image-size", "320"]
STATS_REL = 1e-4      # of each statistic tensor's largest magnitude


def is_stat(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The source checkpoints (JAX: params and batch_stats under ``model``,
    as training wraps them; port: every key under ``model.``, the same
    variables), both tools run once on them, and their siblings read back."""
    tmp = tmp_path_factory.mktemp("recalibrate")
    model = j_rcnn.mobile_net_v3_large_keypoint_rcnn(frozen_stats=False, bn_momentum=0.5)
    variables = randomize(jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)))), np.random.RandomState(61))
    j_dir, p_dir = tmp / "jax" / "checkpoints", tmp / "port" / "checkpoints"
    j_dir.mkdir(parents=True)
    p_dir.mkdir(parents=True)
    payload = {"params": {"model": variables["params"]},
               "batch_stats": {"model": variables["batch_stats"]},
               "opt_state": {"mu": np.arange(3.0)}, "step": 7, "epoch": 2}
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save((j_dir / "epoch=2-step=7").resolve(), payload, force=True)
    sd = {k: torch.from_numpy(np.asarray(v))
          for k, v in weights.detection_state_dict(variables).items()}
    source = {"model": {"model." + k: t for k, t in sd.items()},
              "optimizer": {"state": {0: {"momentum_buffer": torch.arange(3.0)}},
                            "param_groups": [{"lr": 5e-3, "params": [0]}]},
              "accum": None, "step": 7, "epoch": 2}
    torch.save(source, p_dir / "epoch=2-step=7")

    mp = pytest.MonkeyPatch()
    mp.setattr(sys, "argv", ["recalibrate_bn.py", "--ckpt", str(j_dir)] + ARGS)
    try:
        j_tool.main()
    finally:
        mp.undo()
    out = recalibrate_bn.main(["--ckpt", str(p_dir)] + ARGS + ["--device", "cpu"])
    j_new = j_load_checkpoint(latest_checkpoint(j_dir))
    j_sd = weights.detection_state_dict({"params": j_new["params"]["model"],
                                         "batch_stats": j_new["batch_stats"]["model"]})
    return dict(sd=sd, source=source, out=out, p_dir=p_dir, j_dir=j_dir, j_sd=j_sd,
                new=torch.load(out, weights_only=True))


def test_statistics_match_jax(runs):
    """Every running statistic within 1e-4 of JAX's, relative to the tensor's
    largest magnitude (measured: ~4e-6, float32 sums in other orders); every
    one moved from the source."""
    new = runs["new"]["model"]
    stats = [k for k in runs["j_sd"] if is_stat(k)]
    assert len(stats) == 2 * sum(isinstance(m, LiveBatchNorm2d) for m in
                                 recalibrate_bn.mobile_net_v3_large_keypoint_rcnn(
                                     frozen_stats=False).modules())
    for k in stats:
        got, want = new["model." + k].numpy(), np.asarray(runs["j_sd"][k])
        assert np.abs(got - want).max() <= STATS_REL * np.abs(want).max(), k
        assert not torch.equal(new["model." + k], runs["sd"][k]), k


def test_parameters_and_payload_are_the_sources(runs):
    """Parameters bit-equal, the optimiser state, epoch and accumulation
    unchanged, the wrapper's prefix kept, the step one more."""
    new, source = runs["new"], runs["source"]
    assert set(new["model"]) == set(source["model"])
    for k, t in source["model"].items():
        if not is_stat(k):
            assert torch.equal(new["model"][k], t), k
    assert new["optimizer"]["param_groups"] == source["optimizer"]["param_groups"]
    assert torch.equal(new["optimizer"]["state"][0]["momentum_buffer"], torch.arange(3.0))
    assert (new["epoch"], new["step"], new["accum"]) == (2, 8, None)


def test_sibling_is_named_as_jax_and_is_the_newest(runs):
    """``epoch=2-step=8`` beside the source, as JAX's tool names its own, and
    the checkpoint ``latest_checkpoint`` picks from the folder."""
    assert runs["out"] == runs["p_dir"] / "epoch=2-step=8"
    assert latest_checkpoint(runs["p_dir"]) == runs["out"]
    assert latest_checkpoint(runs["j_dir"]).name == runs["out"].name
    assert sorted(p.name for p in runs["p_dir"].iterdir()) == ["epoch=2-step=7",
                                                               "epoch=2-step=8"]


def test_unwrapped_source_and_missing_checkpoint(runs, tmp_path):
    """A ``state_dict`` without the wrapper's prefix is written back without
    it, with the same statistics; a folder with no checkpoint exits."""
    ckpts = tmp_path / "checkpoints"
    ckpts.mkdir()
    plain = dict(runs["source"], model=runs["sd"])
    torch.save(plain, ckpts / "epoch=2-step=7")
    out = recalibrate_bn.main(["--ckpt", str(ckpts / "epoch=2-step=7")] + ARGS
                              + ["--device", "cpu"])
    got = torch.load(out, weights_only=True)["model"]
    assert set(got) == set(runs["sd"])
    for k in got:
        want = runs["new"]["model"]["model." + k]
        assert torch.equal(got[k], want), k
    shutil.rmtree(ckpts)
    ckpts.mkdir()
    with pytest.raises(SystemExit, match="no epoch"):
        recalibrate_bn.main(["--ckpt", str(ckpts), "--device", "cpu"])


def test_mobile_smoke_recipe_matches_jax(monkeypatch, tmp_path):
    """The recipe's fields, loaders and model equal JAX's over the same
    miniature: B = 4 at 320², 2 box slots, 1 epoch, 32 / 8 photos in 8 / 2
    batches, the MobileNetV3 detector with live BatchNorm at momentum 0.9,
    output under ``results_smoke``."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PFR_SMOKE_ROOT", str(PORT / "testdata"))
    monkeypatch.delenv("PFR_SMOKE_EPOCHS", raising=False)
    want = get_dict_wrapper(REPO / "configs" / "smoke" / "keypoint_mobile_smoke.py")
    got = get_config(PORT / "configs" / "keypoint_mobile_smoke.py")
    for key in ("seed", "n_epochs", "train_batch_size", "test_batch_size", "max_boxes",
                "experiment_name", "run_name"):
        assert got[key] == want[key], key
    assert tuple(got.image_size) == tuple(want.image_size) == (320, 320)
    assert Path(got.output).name == Path(want.output).name == "results_smoke"
    for loader in ("train_dataloader", "val_dataloader"):
        assert len(got[loader]()) == len(want[loader]()), loader
    assert (len(got.train_dataloader()), len(got.val_dataloader())) == (8, 2)
    j_model, model = want.model(), got.model()
    for field in ("num_classes", "num_keypoints", "box_detections_per_img",
                  "rpn_pre_nms_top_n_train", "rpn_post_nms_top_n_train",
                  "rpn_pre_nms_top_n_test", "rpn_post_nms_top_n_test", "anchor_sizes",
                  "aspect_ratios"):
        assert getattr(model.cfg, field) == getattr(j_model.cfg, field), field
    norms = [m for m in model.backbone.body.modules() if isinstance(m, LiveBatchNorm2d)]
    assert norms and {m.momentum for m in norms} == {0.9}
    assert (j_model.backbone.backbone.frozen_stats, j_model.backbone.backbone.bn_momentum) == \
        (False, 0.9)
