"""``chip_smoke.py``'s card-against-CPU check of a trained keypoint
checkpoint (``fit_eval_vs_cpu``), run here with the CPU on both sides of a
small keypoint R-CNN over the committed CAT miniature. A rounding-size
difference can move a discrete step of the eval forward (a kept proposal, the
one-detection pick); the check must count such a move and hold the rest with
the CPU forced to the card's decisions, and it must still catch proposals or
detections that the card got wrong."""

import sys

import pytest
import torch

from pets_face_recognition_tpu_torch import eval_landmark
from pets_face_recognition_tpu_torch.engine.checkpoint import save_checkpoint
from pets_face_recognition_tpu_torch.engine.detector_controller import KeyPointsController
from pets_face_recognition_tpu_torch.models import roi_heads, rpn
from pets_face_recognition_tpu_torch.utils import get_config

from test_torch_port_det_entry import CONFIG, PORT

sys.path.insert(0, str(PORT.parent))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("decisions")
    cfg = tmp / "tiny_keypoints.py"
    cfg.write_text(CONFIG.format(data=str(PORT / "testdata"), out=str(tmp / "out")))
    config = get_config(cfg)
    state = KeyPointsController(config=config).init_state(0, "cpu")
    ckpt = save_checkpoint(tmp / "checkpoints", state, 0)
    return cfg, config, ckpt


def check(setup, monkeypatch, owner, name, both=None, card=None) -> dict:
    """``fit_eval_vs_cpu`` with ``owner.name`` wrapped by ``both`` on both
    sides and by ``card`` (in place of ``both``) on the card's: the first
    ``predictions`` call of the check, and ``eval_landmark``."""
    cfg, config, ckpt = setup
    original = getattr(owner, name)
    cpu_side = both(original) if both else original
    card_side = card(original) if card else cpu_side
    monkeypatch.setattr(owner, name, card_side)
    metrics = eval_landmark.evaluate(cfg, ckpt, device="cpu")["val"]
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
    return chip_smoke.fit_eval_vs_cpu(config, ckpt, "cpu", metrics)


def anchors_tied(card: bool):
    """Each image's best anchor and the next of its level a hair apart, in
    the other order on the card."""
    def wrap(forward):
        def tied(self, feats):
            obj, deltas = forward(self, feats)
            obj = obj.clone()
            bounds = [0]
            for f in feats:
                bounds.append(bounds[-1] + f.shape[2] * f.shape[3] * 3)
            for b in range(obj.shape[0]):
                best = int(obj[b].argmax())
                lo = max(x for x in bounds if x <= best)
                hi = min(x for x in bounds if x > best)
                level = obj[b, lo:hi].clone()
                level[best - lo] = -float("inf")
                eps = 1e-6 * abs(float(obj[b, best]))
                obj[b, lo + int(level.argmax())] = obj[b, best] + (eps if card else -eps)
            return obj, deltas
        return tied
    return wrap


def picks_tied(card: bool):
    """Each image's two best foreground candidates a hair apart in score, in
    the other order on the card."""
    def wrap(forward):
        def tied(self, x):
            logits, deltas = forward(self, x)
            c = logits.clone().reshape(8, -1, logits.shape[-1])
            margin = c[..., 1] - c[..., 0]
            for b in range(c.shape[0]):
                first, second = torch.argsort(margin[b], descending=True)[:2].tolist()
                c[b, second, 1] = c[b, second, 0] + margin[b, first] + (1e-6 if card else -1e-6)
            return c.reshape(logits.shape), deltas
        return tied
    return wrap


def test_the_same_device_agrees_with_itself(setup, monkeypatch):
    r = check(setup, monkeypatch, rpn.RPN, "forward")
    assert r["failed"] == [] and r["rpn_rel"] == 0.0 and r["replay_differs"] == 0
    assert r["moved_images"] == r["proposal_slot_moves"] == r["pick_moves"] == 0
    assert r["end_to_end"]["images"] == 8 and r["end_to_end"]["score_abs"] == 0.0
    assert r["forced"]["box_rel_to_side"] == 0.0


def test_a_tie_among_the_proposals_is_counted_and_the_rest_forced(setup, monkeypatch):
    r = check(setup, monkeypatch, rpn.RPN, "forward", anchors_tied(False), anchors_tied(True))
    assert r["failed"] == [] and 0 < r["rpn_rel"] < 1e-5 and r["replay_differs"] == 0
    assert r["proposal_slot_moves"] == 8 and r["pick_moves"] == 0
    assert r["forced"]["score_abs"] == 0.0 and r["forced"]["box_rel_to_side"] == 0.0


def test_a_tie_at_the_pick_is_counted_and_forced(setup, monkeypatch):
    r = check(setup, monkeypatch, roi_heads.FastRCNNPredictor, "forward", picks_tied(False),
              picks_tied(True))
    assert r["failed"] == [] and r["pick_moves"] > 0 and r["proposal_moves"] == 0
    assert r["end_to_end"]["images"] == 8 - r["moved_images"]
    assert max(r["pick_gaps"]) < 1e-5 and r["forced"]["box_rel_to_side"] == 0.0


def test_proposals_the_card_kept_wrongly_are_caught(setup, monkeypatch):
    """The card's NMS keeps every box: the CPU does not keep the card's
    proposals from the card's RPN outputs."""
    r = check(setup, monkeypatch, rpn, "nms_keep_sorted_batch_cuda",
              card=lambda nms: lambda boxes, valid, thresh: valid.clone())
    assert "replay_differs" in r["failed"] and r["replay_differs"] == 8


def test_detections_the_card_got_wrong_are_caught(setup, monkeypatch):
    """The card's box regression off by 0.05: held with the CPU forced to
    the card's decisions, the boxes differ."""
    def shifted(forward):
        def off(self, x):
            logits, deltas = forward(self, x)
            return logits, deltas + 0.05
        return off

    r = check(setup, monkeypatch, roi_heads.FastRCNNPredictor, "forward", card=shifted)
    assert "forced box_rel_to_side" in r["failed"]
