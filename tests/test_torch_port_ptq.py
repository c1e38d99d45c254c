"""The port's PTQ serving workflow (``models/ptq.py``, the ``PFR_QUANT_*``
contract in ``pipelines.py``) and the near-tie rank contract, mirroring the
JAX ``tests/test_ptq_serving.py`` and ``tests/test_int8_rank_contract.py``:

- the environment's validation and components, and JAX's messages (a
  missing state file, a state calibrated under another configuration, a
  component a factory does not support);
- calibrate -> save -> a fresh model loads the state and serves int8, bit for
  bit as the in-memory state does; running-max calibration widens the scales;
- the rank contract on a random-init ResNet-50 embedder at 112 x 112 (40
  gallery and 8 query cards of near-duplicate crops, JAX's initial weights
  carried over) at the JAX test's absolute budget (score drift below 1.5e-3,
  every rank inversion across a float gap below it);
- ``near_tie`` against ``tools/verify_near_tie_contract.py`` on the same
  dumps: the same JSON and exit code.
"""

import importlib.util
import json
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pets_face_recognition_tpu.models import ptq as j_ptq
from pets_face_recognition_tpu.models.embedder import resnet50_embedder as j_resnet50_embedder
from pets_face_recognition_tpu_torch import near_tie, pipelines, retrieval, weights
from pets_face_recognition_tpu_torch.models import ptq, quant, rcnn
from pets_face_recognition_tpu_torch.models.embedder import resnet50_embedder

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
STAGES = (1, 1, 1, 1)


def _tool():
    spec = importlib.util.spec_from_file_location(
        "verify_near_tie_contract", REPO / "tools" / "verify_near_tie_contract.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _embedder(seed=3, mode="calibrate"):
    return weights.init_random_(resnet50_embedder(32, stage_sizes=STAGES, quant=mode), seed).eval()


@pytest.fixture(autouse=True)
def clean_registry():
    ptq._REGISTRY.clear()
    yield
    ptq._REGISTRY.clear()


def test_quant_mode_env_validation(monkeypatch):
    monkeypatch.delenv(ptq.QUANT_MODE_ENV, raising=False)
    monkeypatch.delenv(ptq.QUANT_COMPONENTS_ENV, raising=False)
    assert ptq.quant_mode() == "" and ptq.quant_components() == {"embedder", "detector",
                                                                   "kp_head"}
    assert ptq._state_path() == Path("quant_state.pkl")
    monkeypatch.setenv(ptq.QUANT_MODE_ENV, "bogus")
    assert _error(ptq.quant_mode) == _error(j_ptq.quant_mode)
    assert _error(ptq.quant_mode)[0] is ValueError
    monkeypatch.setenv(ptq.QUANT_MODE_ENV, "int8")
    assert ptq.quant_mode() == "int8"
    monkeypatch.setenv(ptq.QUANT_COMPONENTS_ENV, "embedder, kp_head")
    assert ptq.quant_components() == {"embedder", "kp_head"} == j_ptq.quant_components()
    monkeypatch.setenv(ptq.QUANT_COMPONENTS_ENV, "embedder,typo")
    assert _error(ptq.quant_components) == _error(j_ptq.quant_components)


def _error(fn):
    try:
        fn()
    except Exception as e:    # noqa: BLE001 - the message is what is compared
        return type(e), str(e)
    raise AssertionError("no error")


def test_int8_mode_requires_state_file(tmp_path, monkeypatch):
    missing = tmp_path / "missing.pkl"
    monkeypatch.setenv(ptq.QUANT_STATE_ENV, str(missing))
    runner = ptq.PTQServing("emb", _embedder())
    got = _error(lambda: ptq.PTQModelFn(runner, "int8"))
    assert got[0] is FileNotFoundError
    assert got == _error(lambda: j_ptq.load_quant_state("emb"))
    with open(tmp_path / "other.pkl", "wb") as f:
        pickle.dump({"x": {}}, f)
    assert (_error(lambda: ptq.load_quant_state("emb", tmp_path / "other.pkl"))
            == _error(lambda: j_ptq.load_quant_state("emb", tmp_path / "other.pkl")))


def test_calibrate_save_int8_round_trip(tmp_path, monkeypatch, capsys):
    """``PTQModelFn`` in calibrate mode gives the float output and, saved,
    its state serves a fresh model int8: equal to the in-memory int8 bit for
    bit, cosine-close to float."""
    state_path = tmp_path / "qs.pkl"
    monkeypatch.setenv(ptq.QUANT_STATE_ENV, str(state_path))
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.rand(3, 64, 64, 3).astype(np.float32))
    float_model = weights.init_random_(resnet50_embedder(32, stage_sizes=STAGES), 3).eval()
    with torch.no_grad():
        want = float_model(x)
    fn = ptq.PTQModelFn(ptq.PTQServing("emb", _embedder()), "calibrate")
    assert torch.equal(fn(x), want)
    in_memory = fn.runner.serve(x)
    ptq.save_quant_state()                      # what the exit hook does
    out = capsys.readouterr().out
    assert "PTQ: emb: calibrated submodules ['layer1', 'layer2', 'layer3', 'layer4']" in out
    assert f"PTQ: saved quant state for ['emb'] -> {state_path}" in out
    with open(state_path, "rb") as f:
        saved = pickle.load(f)
    assert set(saved) == {"emb"} and saved["emb"]["layer1.0.in_q.seen"].item()
    fn8 = ptq.PTQModelFn(ptq.PTQServing("emb", _embedder(mode="int8")), "int8")
    got = fn8(x)
    assert torch.equal(got, in_memory)
    cos = torch.nn.functional.cosine_similarity(got, want)
    assert float(cos.min()) > 0.99, cos


def test_running_max_calibration_widens_scales():
    runner = ptq.PTQServing("emb", _embedder())
    runner.calibrate(torch.full((1, 64, 64, 3), 0.1))
    small = {k: v.copy() for k, v in runner.quant_numpy().items() if k.endswith(".scale")}
    runner.calibrate(torch.full((1, 64, 64, 3), 1.0))
    big = {k: v for k, v in runner.quant_numpy().items() if k.endswith(".scale")}
    assert small and big.keys() == small.keys()
    assert all(big[k] >= small[k] for k in small)
    assert any(big[k] > small[k] for k in small)


def test_quant_state_tree_mismatch_raises_jax_message():
    """A state calibrated with the keypoint head alone does not load into a
    detector quantized at scope ``rpn`` as well."""
    kp_only = rcnn.keypointrcnn_resnet50_fpn(stage_sizes=STAGES, quant_kp="calibrate")
    state = ptq.PTQServing("det_keypoint_prod", kp_only).quant_numpy()
    both = rcnn.keypointrcnn_resnet50_fpn(stage_sizes=STAGES, quant="int8", quant_kp="int8")
    runner = ptq.PTQServing("det_keypoint_prod", both)
    with pytest.raises(ValueError) as err:
        runner.load_quant(state)
    assert str(err.value) == (
        "det_keypoint_prod: quant-state tree mismatch — the saved state was calibrated "
        "under a different model configuration (e.g. a different PFR_QUANT_COMPONENTS). "
        "Re-run calibrate mode with the SAME component subset and state path as this "
        "int8 run.")
    with pytest.raises(ValueError, match="no quant modules"):
        ptq.PTQServing("x", rcnn.keypointrcnn_resnet50_fpn(stage_sizes=STAGES))


def _jax_detector_message(capsys, name, supports):
    """What the JAX ``configs/pipelines.py::_detector_fn`` prints before it
    loads the checkpoint (there is none here, so the load raises)."""
    spec = importlib.util.spec_from_file_location("_pfr_pipelines_test",
                                                  REPO / "configs" / "pipelines.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(Exception):  # noqa: B017 - no checkpoint exists
        mod._detector_fn(name, lambda q, qkp: None, Path("no-checkpoint-here"), supports=supports)
    return capsys.readouterr().out


@pytest.mark.parametrize("mode,components,name,supports,flags", [
    ("calibrate", "detector,kp_head", "det_mask", ("detector",), ("calibrate", None)),
    ("int8", "detector,kp_head", "det_keypoint_mobile_prod", ("kp_head",), (None, "int8")),
    ("int8", "kp_head", "det_mask", ("detector",), (None, None)),
    ("int8", "embedder", "det_keypoint_prod", ("detector", "kp_head"), (None, None)),
    ("", "detector", "det_mask", ("detector",), (None, None)),
])
def test_component_fallback_and_message(monkeypatch, capsys, mode, components, name, supports,
                                        flags):
    """A requested component the factory lacks falls back to float with
    JAX's message; none left: float, with JAX's message."""
    monkeypatch.setenv(ptq.QUANT_MODE_ENV, mode)
    monkeypatch.setenv(ptq.QUANT_COMPONENTS_ENV, components)
    assert pipelines.detector_quant(name, supports) == (mode, *flags)
    ours = capsys.readouterr().out
    assert ours == _jax_detector_message(capsys, name, supports)
    if mode and flags == (None, None):
        assert "serving FLOAT" in ours


def test_mask_factory_serves_float_without_its_component(monkeypatch, tmp_path, capsys):
    """``mask_detector`` under ``PFR_QUANT_COMPONENTS=kp_head``: a plain float
    model (no quant buffers), no state file needed."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("PFR_MASK_CKPT", raising=False)
    monkeypatch.setenv(ptq.QUANT_MODE_ENV, "int8")
    monkeypatch.setenv(ptq.QUANT_COMPONENTS_ENV, "kp_head")
    det = pipelines.mask_detector("cpu")
    assert not isinstance(det, ptq.PTQModelFn) and not quant.quant_state(det)
    assert "det_mask: no supported quant components" in capsys.readouterr().out


# -- the rank contract (tests/test_int8_rank_contract.py) -------------------

SIZE = 112
N_GALLERY, N_QUERY, N_IMGS = 40, 8, 2
RANDOM_INIT_BUDGET = 1.5e-3      # the JAX test's pinned budget


def _hard_crops(rng, n_cards, n_imgs):
    """Near-duplicate tinted crops, as the JAX test draws them."""
    centers = rng.uniform(0.2, 0.6, (6, 3))
    crops = np.zeros((n_cards, n_imgs, SIZE, SIZE, 3), np.float32)
    for c in range(n_cards):
        tint = np.clip(centers[rng.randint(6)] + rng.normal(0, 0.02, 3), 0, 1)
        for j in range(n_imgs):
            img = np.clip(tint + rng.normal(0, 0.03, 3) + rng.normal(0, 0.05, (SIZE, SIZE, 3)),
                          0, 1)
            cx, cy = rng.randint(SIZE // 3, 2 * SIZE // 3, 2)
            d = rng.randint(12, 20)
            yy, xx = np.mgrid[:SIZE, :SIZE]
            for (px, py) in ((cx - d, cy), (cx + d, cy), (cx, cy + d)):
                img[(xx - px) ** 2 + (yy - py) ** 2 < 9] = 1.0
            crops[c, j] = img
    return crops


def _embed_all(fn, crops, batch=16):
    flat = torch.from_numpy(crops.reshape(-1, SIZE, SIZE, 3))
    emb = torch.cat([fn(flat[i:i + batch]) for i in range(0, len(flat), batch)]).numpy()
    emb = emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)
    return emb.reshape(crops.shape[0], crops.shape[1], -1).mean(1)


def test_int8_only_flips_near_ties():
    rng = np.random.RandomState(0)
    gallery = _hard_crops(rng, N_GALLERY, N_IMGS)
    queries = _hard_crops(rng, N_QUERY, N_IMGS)
    j_model = j_resnet50_embedder(embedding_dim=64)
    variables = jax.jit(j_model.init)(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    sd = weights.to_tensors(weights.embedder_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                               variables)))
    float_model = resnet50_embedder(64)
    float_model.load_state_dict(sd)
    runner = ptq.PTQServing("emb", quant.load_float_state_dict(
        resnet50_embedder(64, quant="calibrate"), sd).eval())
    _embed_all(runner.calibrate, gallery)          # the corpus is the calibration set

    def float_fn(x):
        with torch.no_grad():
            return float_model.eval()(x)

    gf, gq = _embed_all(float_fn, gallery), _embed_all(float_fn, queries)
    g8, q8 = _embed_all(runner.serve, gallery), _embed_all(runner.serve, queries)
    s_f = retrieval.pairwise_card_scores(gq, gf, "cpu")
    s_8 = retrieval.pairwise_card_scores(q8, g8, "cpu")
    drift = np.abs(s_f - s_8).max()
    assert drift < RANDOM_INIT_BUDGET, drift
    names = np.array([f"g{i}" for i in range(N_GALLERY)])
    dumps = [{f"q{q}": {"gallery": names, "scores": s[q], "include": np.ones(N_GALLERY, bool)}
              for q in range(N_QUERY)} for s in (s_f, s_8)]
    report = retrieval.near_tie_report(*dumps)
    assert report["max_flip_float_gap"] <= RANDOM_INIT_BUDGET, report["worst_flip"]


# -- near_tie against the JAX package's tool ---------------------------------


def _dump(path, rng, queries, gallery, noise=0.0, base=None):
    out = {}
    for q in queries:
        scores = (base[q]["scores"] + rng.randn(len(gallery)).astype(np.float32) * noise
                  if base and q in base else rng.rand(len(gallery)).astype(np.float32))
        out[q] = {"gallery": np.array(gallery), "scores": scores.astype(np.float32),
                  "include": rng.rand(len(gallery)) > 0.1}
    retrieval.write_scores_dump(out, path)
    return out


@pytest.mark.parametrize("noise,drift_budget,flip_budget", [
    (1e-4, 5e-4, 5e-4), (1e-3, 5e-4, 5e-4), (1e-5, 1e-3, 1e-6)])
def test_near_tie_matches_the_tool(tmp_path, monkeypatch, capsys, noise, drift_budget,
                                   flip_budget):
    """The same dumps through ``python -m pets_face_recognition_tpu_torch.near_tie``
    and the JAX tool: the same JSON and exit code; queries and gallery cards
    in one dump only are reported as membership churn."""
    rng = np.random.RandomState(int(noise * 1e6))
    gallery = [f"card_{i}" for i in range(30)]
    a = _dump(tmp_path / "f.npz", rng, [f"q{i}" for i in range(12)], gallery)
    _dump(tmp_path / "i.npz", rng, [f"q{i}" for i in range(1, 13) if i != 5],
          gallery[:-2] + ["x"], noise, {q: {"scores": np.r_[v["scores"][:28], 0.5]}
                                        for q, v in a.items()})
    args = [str(tmp_path / "f.npz"), str(tmp_path / "i.npz"), "--drift-budget", str(drift_budget),
            "--flip-budget", str(flip_budget)]
    rc = near_tie.main(args)
    ours = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["verify_near_tie_contract.py", *args])
    assert rc == _tool().main()
    theirs = capsys.readouterr().out
    assert json.loads(ours) == json.loads(theirs)
    report = json.loads(ours)
    assert report["only_a"] == ["q0", "q5"] and report["only_b"] == ["q12"]
    assert report["gallery_only_b"] == ["x"]
