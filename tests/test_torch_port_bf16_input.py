"""``PFR_INPUT_DTYPE`` against the JAX package on the CPU, on shared weights:
``bfloat16`` rounds the detector's batch at the device boundary in
``Preproc3`` (JAX ``preprocessor/__init__.py:200-205``) and the embedder's
input crop in the head pipeline (JAX ``configs/retrieval_common.py:95-99``);
any other value than ``float32`` and ``bfloat16`` raises. The models are
float32, where the rounding shows (a bfloat16 model's first layer rounds its
input anyway); one block a stage at production widths, 128 x 128 photos.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pets_face_recognition_tpu import preprocessor as j_preprocessor
from pets_face_recognition_tpu.preprocessor import Preproc3 as JPreproc3
from pets_face_recognition_tpu_torch import preprocessor
from pets_face_recognition_tpu_torch.pipelines import build_head_pipeline
from pets_face_recognition_tpu_torch.preprocessor import Preproc3

from test_torch_port_bf16_serving import BF, IMG, _models

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def f32_models():
    m = _models(21, jnp.float32, torch.float32)
    m["det_fn"] = jax.jit(lambda x: m["j_det"].apply(m["det_vars"], x))
    m["emb_fn"] = jax.jit(lambda x: m["j_emb"].apply(m["emb_vars"], x))
    m["photos"] = [m["rng"].randint(0, 256, (IMG, IMG, 3)).astype(np.uint8) for _ in range(3)]
    return m


def test_input_dtype_rounds_the_detector_batch_as_jax(f32_models, monkeypatch):
    """``PFR_INPUT_DTYPE=bfloat16`` rounds ``Preproc3``'s batch to bfloat16 at
    the device boundary, on both sides, for float32 detectors (a bfloat16
    detector's first layer rounds it anyway): the same validity and rounded
    landmarks, scores within float32 rounding of a conv chain; and the
    rounding shows, the scores moving from the float32-input ones."""
    m = f32_models
    runs = {}
    for mode in ("float32", "bfloat16"):
        monkeypatch.setenv("PFR_INPUT_DTYPE", mode)
        want = JPreproc3(model_fn=m["det_fn"], thr=0.0, input_size=(IMG, IMG)).batch(m["photos"])
        got = Preproc3(m["det"], thr=0.0, input_size=(IMG, IMG), device="cpu").batch(
            m["photos"])
        runs[mode] = (want, got)
        (_, w_ok, w_raw), (_, g_ok, g_raw) = want, got
        np.testing.assert_array_equal(g_ok, w_ok)
        np.testing.assert_array_equal(g_raw["keypoints"], w_raw["keypoints"])
        np.testing.assert_allclose(g_raw["scores"], w_raw["scores"], rtol=1e-4, atol=1e-5)
    for side in (0, 1):
        assert not np.array_equal(runs["float32"][side][2]["scores"],
                                  runs["bfloat16"][side][2]["scores"])


def test_input_dtype_rounds_the_embedder_input_as_jax(f32_models, monkeypatch):
    """Under ``PFR_INPUT_DTYPE=bfloat16`` the head pipeline hands its embedder
    the crop rounded to bfloat16 (JAX ``retrieval_common.py:95-99``), and the
    port's embedder on it agrees with JAX's embedder on JAX's bfloat16 crop."""
    m = f32_models
    monkeypatch.setenv("PFR_INPUT_DTYPE", "bfloat16")
    monkeypatch.setenv("PFR_RETRIEVAL_THR", "0.0")
    seen = []

    class Spy(torch.nn.Module):
        def forward(self, x):
            seen.append(x.clone())
            return m["emb"](x)

    head = build_head_pipeline(m["det"], Spy(), Spy(), device="cpu")
    pre = Preproc3(m["det"], thr=0.0, device="cpu", input_size=(320, 320))
    photo = m["photos"][0]
    vec = head(photo, 1)
    assert vec is not None and len(seen) == 1
    x = pre(photo)[None] / 255.0
    assert torch.equal(seen[0], x.to(torch.bfloat16).float())
    want = np.asarray(m["emb_fn"](jnp.asarray(x.numpy()).astype(BF)))
    np.testing.assert_allclose(vec, want[0], rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_input_dtype_refuses_other_values(monkeypatch):
    """Any value but float32 and bfloat16 raises, on both sides."""
    monkeypatch.setenv("PFR_INPUT_DTYPE", "float16")
    with pytest.raises(ValueError, match="PFR_INPUT_DTYPE"):
        preprocessor.input_dtype()
    with pytest.raises(ValueError, match="PFR_INPUT_DTYPE"):
        j_preprocessor._input_dtype()
    monkeypatch.setenv("PFR_INPUT_DTYPE", "bfloat16")
    assert preprocessor.input_dtype() == j_preprocessor._input_dtype() == "bfloat16"
