"""The ``PFR_QUANT_*`` contract through the port's entry points on the CPU, as
the JAX ``configs/pipelines.py`` and ``configs/retrieval_common.py`` read it:

- ``generate_tsv`` (head) in float with ``PFR_SCORES_DUMP``, under
  ``calibrate`` (the state written at exit, which names each model's
  calibrated submodules) and under ``int8`` with a dump: every query's row in
  both dumps and ``near_tie`` holding the contract between them; ``--body``
  calibrated and served int8 as well, over four cards; ``int8`` without a
  state file stops with JAX's message;
- the detector factories of ``transform_dataset``, ``transform_reproduce``
  and ``prepare_tables`` (``pipelines.keypoint_detector``,
  ``pipelines.mask_detector``) under each mode, and ``transform_dataset``
  run under ``calibrate`` then ``int8``.

In-process runs cut every trunk to one block a stage; one subprocess runs
``generate_tsv`` at full width, so that the state is written by the exit
hook itself.
"""

import atexit
import os
import pickle
import shutil
import subprocess
import sys
from functools import partial
from pathlib import Path

import pytest
import torch

from pets_face_recognition_tpu_torch import (generate_tsv, near_tie, pipelines, retrieval,
                                             serving, transform_dataset)
from pets_face_recognition_tpu_torch.models import ptq

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CORPUS = REPO / "pets_face_recognition_tpu_torch" / "testdata" / "kashtanka_test"
STAGES = (1, 1, 1, 1)
MISSING_STATE = "PFR_QUANT_MODE=int8 requires a calibrated quant state at"


@pytest.fixture
def small(monkeypatch, tmp_path):
    """Trunks cut to one block a stage (Mask R-CNN's RPN to 64 proposals),
    a clean registry, no exit hook left behind, the working directory in
    ``tmp_path``, and ``data/``: one card of each folder of the corpus."""
    monkeypatch.setattr(serving, "keypointrcnn_resnet50_fpn",
                        partial(serving.keypointrcnn_resnet50_fpn, stage_sizes=STAGES))
    monkeypatch.setattr(pipelines, "resnet50_embedder",
                        partial(pipelines.resnet50_embedder, stage_sizes=STAGES))
    monkeypatch.setattr(pipelines, "maskrcnn_resnet50_fpn",
                        partial(pipelines.maskrcnn_resnet50_fpn, stage_sizes=STAGES,
                                rpn_pre_nms_top_n_test=64, rpn_post_nms_top_n_test=64))
    for var in ("PFR_KEYPOINT_CKPT", "PFR_MASK_CKPT", ptq.QUANT_COMPONENTS_ENV):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PFR_RETRIEVAL_THR", "0.0")
    monkeypatch.chdir(tmp_path)
    for folder in sorted(CORPUS.glob("*/*")):
        card = sorted(p for p in folder.iterdir() if p.is_dir())[0]
        shutil.copytree(card, tmp_path / "data" / folder.relative_to(CORPUS) / card.name)
    ptq._REGISTRY.clear()
    yield tmp_path
    ptq._REGISTRY.clear()
    atexit.unregister(ptq.save_quant_state)
    ptq._atexit_installed = False


def _run(monkeypatch, mode, argv, state, dump=None):
    monkeypatch.setenv(ptq.QUANT_MODE_ENV, mode)
    monkeypatch.setenv(ptq.QUANT_STATE_ENV, str(state))
    if dump:
        monkeypatch.setenv("PFR_SCORES_DUMP", str(dump))
    else:
        monkeypatch.delenv("PFR_SCORES_DUMP", raising=False)
    ptq._REGISTRY.clear()
    generate_tsv.main(["--device", "cpu", "--data", "data", *argv])
    if mode == "calibrate":
        ptq.save_quant_state()                        # what the exit hook does


def _dump_rows(path):
    return len(retrieval.load_scores_dump(path))


def _tsv_rows(path):
    return len(path.read_text().splitlines()) - 1


def test_generate_tsv_float_calibrate_int8(small, monkeypatch, capsys):
    """Cut-depth models over four cards (their random landmarks can be
    degenerate, whose crops are NaN, so scores are compared in the full-width
    test below)."""
    state = small / "qs.pkl"
    _run(monkeypatch, "", ["--output", "f.tsv"], state, small / "f.npz")
    with pytest.raises(FileNotFoundError, match=MISSING_STATE):
        _run(monkeypatch, "int8", ["--output", "x.tsv"], state)
    _run(monkeypatch, "calibrate", ["--output", "c.tsv"], state)
    out = capsys.readouterr().out
    assert "PTQ: det_keypoint_prod: calibrated submodules ['backbone', 'roi_heads', 'rpn']" in out
    with open(state, "rb") as f:
        assert set(pickle.load(f)) == {"det_keypoint_prod", "fe_dog_head", "fe_cat_head"}
    # the calibrate pass is the float pass
    assert (small / "c.tsv").read_bytes() == (small / "f.tsv").read_bytes()
    _run(monkeypatch, "int8", ["--output", "i.tsv"], state, small / "i.npz")
    assert _dump_rows(small / "f.npz") == _tsv_rows(small / "f.tsv") > 0
    assert _dump_rows(small / "i.npz") == _tsv_rows(small / "i.tsv")



def test_generate_tsv_body_calibrate_int8(small, monkeypatch, capsys):
    """The head+body ensemble (``--body``): its own calibration of six
    models, then int8, over one card of each folder of the corpus."""
    state = small / "body.pkl"
    _run(monkeypatch, "calibrate", ["--body", "--output", "cb.tsv"], state)
    with open(state, "rb") as f:
        assert set(pickle.load(f)) == {"det_keypoint_prod", "fe_dog_head", "fe_cat_head",
                                       "det_mask", "fe_dog_body", "fe_cat_body"}
    assert "PTQ: det_mask: calibrated submodules ['backbone', 'rpn']" in capsys.readouterr().out
    _run(monkeypatch, "int8", ["--body", "--output", "ib.tsv"], state,
         small / "ib.npz")
    assert _dump_rows(small / "ib.npz") == _tsv_rows(small / "ib.tsv")


@pytest.mark.parametrize("mode", ["calibrate", "int8"])
def test_transform_factories_obey_the_mode(small, monkeypatch, mode):
    """The detectors of ``transform_dataset``, ``transform_reproduce`` and
    ``prepare_tables`` are PTQ twins under each mode, under JAX's names, and
    float with the components that they lack."""
    state = small / "qs.pkl"
    monkeypatch.setenv(ptq.QUANT_STATE_ENV, str(state))
    monkeypatch.setenv(ptq.QUANT_MODE_ENV, "calibrate")
    pipelines.keypoint_detector("cpu")
    pipelines.mask_detector("cpu")
    ptq.save_quant_state()
    ptq._REGISTRY.clear()
    monkeypatch.setenv(ptq.QUANT_MODE_ENV, mode)
    kp, mask = pipelines.keypoint_detector("cpu"), pipelines.mask_detector("cpu")
    assert (kp.runner.name, mask.runner.name) == ("det_keypoint_prod", "det_mask")
    assert kp.mode == mask.mode == mode
    monkeypatch.setenv(ptq.QUANT_COMPONENTS_ENV, "embedder")
    assert not isinstance(pipelines.keypoint_detector("cpu"), ptq.PTQModelFn)


def test_transform_dataset_calibrate_then_int8(small, monkeypatch):
    photos = small / "photos"
    (photos / "cards").mkdir(parents=True)
    for i, p in enumerate(sorted(CORPUS.rglob("*.jpg"))[:4]):
        shutil.copy(p, photos / "cards" / f"{i}.jpg")
    state = small / "qs.pkl"
    monkeypatch.setenv(ptq.QUANT_STATE_ENV, str(state))
    for mode in ("calibrate", "int8"):
        monkeypatch.setenv(ptq.QUANT_MODE_ENV, mode)
        ptq._REGISTRY.clear()
        written = transform_dataset.main(["--input", str(photos), "--output", str(small / mode),
                                          "--thr", "0.0", "--batch-size", "4", "--device", "cpu"])
        assert written
        if mode == "calibrate":
            ptq.save_quant_state()
            with open(state, "rb") as f:
                assert set(pickle.load(f)) == {"det_keypoint_prod"}


def test_generate_tsv_int8_chain_at_full_width(tmp_path):
    """At full width in subprocesses, over the committed corpus: the float
    chain with a scores dump; int8 without a state file exits nonzero with
    JAX's message; calibrate writes the state when the process exits; int8
    with a dump. Every query's row is in both dumps, and ``near_tie`` holds
    the float and int8 dumps to the contract (rank flips only across float
    gaps below 5e-4; the drift itself is not bounded here)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("PFR_")}
    env.update(PYTHONPATH=str(REPO), PFR_RETRIEVAL_THR="0.0",
               PFR_QUANT_STATE=str(tmp_path / "qs.pkl"))

    def run(mode, name, dump=True):
        e = dict(env, PFR_QUANT_MODE=mode)
        if dump:
            e["PFR_SCORES_DUMP"] = str(tmp_path / f"{name}.npz")
        return subprocess.run([sys.executable, "-m", "pets_face_recognition_tpu_torch.generate_tsv",
                               "--device", "cpu", "--output", str(tmp_path / f"{name}.tsv")],
                              cwd=tmp_path, env=e, capture_output=True, text=True, timeout=600)

    assert run("", "f").returncode == 0
    out = run("int8", "x", dump=False)
    assert out.returncode != 0 and MISSING_STATE in out.stderr
    out = run("calibrate", "c", dump=False)
    assert out.returncode == 0, out.stderr
    assert "PTQ: saved quant state for ['det_keypoint_prod', 'fe_cat_head', 'fe_dog_head'] " \
           f"-> {tmp_path / 'qs.pkl'}" in out.stdout
    assert run("int8", "i").returncode == 0
    for name in "fi":
        assert _dump_rows(tmp_path / f"{name}.npz") == _tsv_rows(tmp_path / f"{name}.tsv") > 0
    report = near_tie.check(tmp_path / "f.npz", tmp_path / "i.npz", drift_budget=1.0,
                            flip_budget=5e-4)
    assert report["contract"] == "NEAR-TIE-SAFE", report
    assert 0 < report["max_score_drift"] < 1e-2, report
