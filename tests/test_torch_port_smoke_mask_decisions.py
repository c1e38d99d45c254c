"""``chip_smoke.py``'s card-against-CPU check of a trained Mask R-CNN
checkpoint (``eval_card_vs_cpu``), run here with the CPU on both sides of a
small Mask R-CNN over a seeded Oxford-IIIT Pet miniature. A rounding-size
difference can move a discrete step of the eval forward (a kept proposal, a
score at the 0.05 threshold, the order of two near-equal detections); the
check must count such a move and hold the rest with the CPU forced to the
card's decisions, and it must still catch detections that the card picked or
regressed wrongly."""

import math
import sys

import pytest
import torch

from pets_face_recognition_tpu_torch.engine.checkpoint import save_checkpoint
from pets_face_recognition_tpu_torch.engine.detector_controller import DetectionController
from pets_face_recognition_tpu_torch.models import roi_heads
from pets_face_recognition_tpu_torch.smoke_data import make_oxford
from pets_face_recognition_tpu_torch.utils import get_config

from test_torch_port_mask_entry import CONFIG, PORT

sys.path.insert(0, str(PORT.parent))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mask_decisions")
    make_oxford(tmp / "data", n_imgs=20, size=96)
    cfg = tmp / "tiny_mask.py"
    cfg.write_text(CONFIG.format(data=str(tmp / "data"), out=str(tmp / "out")))
    config = get_config(cfg)
    state = DetectionController(config=config).init_state(0, "cpu")
    return config, save_checkpoint(tmp / "checkpoints", state, 0)


def check(setup, monkeypatch, owner, name, both=None, card=None) -> dict:
    """``eval_card_vs_cpu`` with ``owner.name`` wrapped by ``both`` on both
    sides and by ``card`` (in place of ``both``) on the card's, the first
    ``predictions`` call of the check."""
    config, ckpt = setup
    original = getattr(owner, name)
    cpu_side = both(original) if both else original
    card_side = card(original) if card else cpu_side
    monkeypatch.setattr(owner, name, cpu_side)
    real, calls = chip_smoke.predictions, []

    def predictions(*args):
        calls.append(1)
        if len(calls) > 1:
            return real(*args)
        setattr(owner, name, card_side)
        try:
            return real(*args)
        finally:
            setattr(owner, name, cpu_side)

    monkeypatch.setattr(chip_smoke, "predictions", predictions)
    return chip_smoke.eval_card_vs_cpu(config, ckpt, "cpu")


def scores_set(card: bool, at_threshold: bool):
    """Each image's foreground scores spread far below the 0.05 threshold
    but for its best candidate, which sits a hair above the threshold
    (``at_threshold``; below it on the CPU's side), or whose runner-up sits a
    hair from it in score, in the other order on the card."""
    def wrap(forward):
        def tied(self, x):
            logits, deltas = forward(self, x)
            c = logits.clone().reshape(2, -1, logits.shape[-1])
            margin = c[..., 1] - c[..., 0]
            for b in range(c.shape[0]):
                first, second = torch.argsort(margin[b], descending=True)[:2].tolist()
                if at_threshold:
                    p = 0.05 + (1e-6 if card else -1e-6)
                    c[b, :, 1] = c[b, :, 0] - 10.0
                    c[b, first, 1] = c[b, first, 0] + math.log(p / (1 - p))
                else:
                    c[b, second, 1] = (c[b, second, 0] + margin[b, first]
                                       + (1e-6 if card else -1e-6))
            return c.reshape(logits.shape), deltas
        return tied
    return wrap


def test_the_same_device_agrees_with_itself(setup, monkeypatch):
    r = check(setup, monkeypatch, roi_heads.FastRCNNPredictor, "forward")
    assert r["failed"] == [] and r["rpn_rel"] == 0.0 and r["replay_differs"] == 0
    assert r["moved_images"] == r["pick_moves"] == r["pick_replay_differs"] == 0
    assert r["unmatched_slots"] == 0 and r["detections"] > 0
    assert r["end_to_end"]["images"] == 4 and r["end_to_end"]["score_abs"] == 0.0
    assert r["forced"]["box_rel_to_side"] == 0.0 and r["forced"]["mask_abs"] == 0.0


def test_a_score_at_the_threshold_is_counted_and_forced(setup, monkeypatch):
    r = check(setup, monkeypatch, roi_heads.FastRCNNPredictor, "forward",
              scores_set(False, True), scores_set(True, True))
    assert r["failed"] == [] and r["pick_moves"] == r["moved_images"] == 4
    assert r["proposal_moves"] == 0 and r["detections"] == 4
    assert r["end_to_end"]["images"] == 0 and max(r["pick_gaps"]) < 1e-5
    assert 0 < r["forced"]["score_abs"] < 1e-5 and r["forced"]["box_rel_to_side"] == 0.0
    # end to end, the CPU found none of the card's detections
    assert math.isnan(r["test_cpu"]["val"]["Mean IoU"])
    assert r["test_cpu_forced"]["val"] == r["test_card"]["val"]


def test_two_detections_tied_in_score_are_counted_and_forced(setup, monkeypatch):
    r = check(setup, monkeypatch, roi_heads.FastRCNNPredictor, "forward",
              scores_set(False, False), scores_set(True, False))
    assert r["failed"] == [] and r["pick_moves"] > 0 and r["proposal_moves"] == 0
    assert r["end_to_end"]["images"] == 4 - r["moved_images"]
    assert max(r["pick_gaps"]) < 1e-5 and r["forced"]["box_rel_to_side"] == 0.0


def test_detections_the_card_picked_wrongly_are_caught(setup, monkeypatch):
    """The card's box NMS keeps every box: the CPU's post-process on the
    card's candidates does not pick the card's detections."""
    r = check(setup, monkeypatch, roi_heads, "nms_keep_sorted_batch_cuda",
              card=lambda nms: lambda boxes, valid, thresh: valid.clone())
    assert "pick_replay_differs" in r["failed"] and r["pick_replay_differs"] > 0


def test_detections_the_card_regressed_wrongly_are_caught(setup, monkeypatch):
    """The card's box regression off by 0.05: held with the CPU forced to
    the card's decisions, the boxes differ."""
    def shifted(forward):
        def off(self, x):
            logits, deltas = forward(self, x)
            return logits, deltas + 0.05
        return off

    r = check(setup, monkeypatch, roi_heads.FastRCNNPredictor, "forward", card=shifted)
    assert "forced box_rel_to_side" in r["failed"]
