"""The port's last datasets and public names against the JAX package on the
CPU: ``LMDDataset`` (CelebA faces with animal crops, PIL's zero-padded
``crop`` as a slice), ``LFWDataset`` and ``init_dataset_ms1m`` over miniature
trees written here, ``FocalLoss`` with a learnable alpha,
``binary_focal_sigmoid``, ``DummyWrapper``, ``grid_anchors``,
``bbox_crop_letterbox`` and ``flush_scores_dump``.

Tolerances: datasets, anchors and dumps equal; losses 1e-6 relative and
alpha's gradient 1e-5; the letterbox 1e-4 on [0, 1] pixels (JAX inverts
the map with ``jnp.linalg.inv``, the port in K1's closed form).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pets_face_recognition_tpu import retrieval as jr
from pets_face_recognition_tpu.data_loading import human as j_human
from pets_face_recognition_tpu.data_loading.lmd_dataset import LMDDataset as JLMDDataset
from pets_face_recognition_tpu.losses import DummyWrapper as JDummyWrapper
from pets_face_recognition_tpu.losses.losses import FocalLoss as JFocalLoss
from pets_face_recognition_tpu.losses.losses import binary_focal_sigmoid as j_bfs
from pets_face_recognition_tpu.ops.anchors import generate_anchors as j_generate_anchors
from pets_face_recognition_tpu.ops.anchors import grid_anchors as j_grid_anchors
from pets_face_recognition_tpu.preprocessor import bbox_crop_letterbox as j_letterbox
from pets_face_recognition_tpu_torch import retrieval as tr
from pets_face_recognition_tpu_torch.data_loading import human
from pets_face_recognition_tpu_torch.data_loading.lmd_dataset import LMDDataset, pil_crop
from pets_face_recognition_tpu_torch.losses import DummyWrapper, FocalLoss, binary_focal_sigmoid
from pets_face_recognition_tpu_torch.ops.anchors import generate_anchors, grid_anchors
from pets_face_recognition_tpu_torch.preprocessor import bbox_crop_letterbox

from test_tsv_golden import _synthetic_db

torch.set_num_threads(1)


class _Faces:
    """CelebA stand-in: ``(image, (bbox, landmarks))``, 10 landmark values."""

    def __init__(self, rng, n=7):
        self.items = [(rng.randint(0, 255, (40 + i, 30 + 2 * i, 3)).astype(np.uint8),
                       (rng.randint(0, 20, 4), rng.uniform(0, 30, 10))) for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class _Animals:
    """Oxford stand-in: ``(image, {"boxes"})``, boxes inside and past every edge."""

    BOXES = ([5, 6, 30, 25], [-8, 3, 20, 44], [10, -5, 50, 18], [2, 2, 2, 9], [40, 20, 70, 60])

    def __init__(self, rng):
        self.items = [(rng.randint(0, 255, (48, 52, 3)).astype(np.uint8),
                       {"boxes": np.asarray([b], np.float32)}) for b in self.BOXES]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def test_lmd_dataset_matches_jax():
    """Every item equal: the face, its landmarks over its sides, and the
    animal crop, zero where a box leaves the image."""
    rng = np.random.RandomState(0)
    faces, animals = _Faces(rng), _Animals(rng)
    got, want = LMDDataset(faces, animals, seed=3), JLMDDataset(faces, animals, seed=3)
    np.testing.assert_array_equal(got.support_indexing, want.support_indexing)
    assert len(got) == len(want) == 7
    for i in range(len(got)):
        g, w = got[i], want[i]
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    image = animals[0][0]
    for box in _Animals.BOXES:
        np.testing.assert_array_equal(pil_crop(image, box),
                                      np.asarray(Image.fromarray(image).crop(tuple(box))))
    with pytest.raises(ValueError):
        pil_crop(image, (10, 10, 5, 20))


@pytest.fixture(scope="module")
def lfw_root(tmp_path_factory):
    """people.csv (a blank name and an ``NA`` one among the rows) over three
    people's JPEGs, one gray."""
    root = tmp_path_factory.mktemp("lfw")
    rng = np.random.RandomState(1)
    photos = root / "lfw-deepfunneled" / "lfw-deepfunneled"
    people = {"Ann_Lee": 2, "Bo": 1, "Cy_De_Fa": 3}
    for name, n in people.items():
        (photos / name).mkdir(parents=True)
        for k in range(1, n + 1):
            shape = (20, 18) if name == "Bo" else (20, 18, 3)
            Image.fromarray(rng.randint(0, 255, shape).astype(np.uint8)).save(
                photos / name / f"{name}_{k:04d}.jpg", quality=90)
    (root / "people.csv").write_text("name,images\nCy_De_Fa,3\n,\nAnn_Lee,2\nNA,0\nBo,1\n")
    return root


def test_lfw_dataset_matches_jax(lfw_root):
    got, want = human.LFWDataset(lfw_root), j_human.LFWDataset(lfw_root)
    assert got.keys == want.keys and got.labels == want.labels
    assert got.uid_to_indices == want.uid_to_indices and got.get_users() == want.get_users()
    assert got.inverted_keys == want.inverted_keys and len(got) == len(want) == 6
    for i in range(len(got)):
        g, w = got[i], want[i]
        assert (g["label"], g["index"]) == (w["label"], w["index"])
        np.testing.assert_array_equal(g["x"], w["x"])


def test_init_dataset_ms1m_matches_jax(lfw_root):
    photos = lfw_root / "lfw-deepfunneled" / "lfw-deepfunneled"
    (photos / "stray.txt").write_text("not a folder")
    assert human.init_dataset_ms1m(photos) == j_human.init_dataset_ms1m(photos)


def test_focal_loss_learnable_alpha_matches_jax():
    """A learnable per-class alpha (ones, then a random draw) and row weights:
    the loss within 1e-6 relative, alpha's gradient within 1e-5."""
    rng = np.random.RandomState(2)
    logits = rng.randn(9, 5).astype(np.float32) * 3
    labels = rng.randint(0, 5, 9)
    weights = rng.rand(9).astype(np.float32)
    alpha = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    j_mod = JFocalLoss(gamma=2.0, num_classes=5, learnable_alpha=True)
    init = j_mod.init(jax.random.PRNGKey(0), jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_array_equal(np.asarray(init["params"]["alpha"]), np.ones(5, np.float32))
    t_mod = FocalLoss(gamma=2.0, num_classes=5, learnable_alpha=True)
    assert torch.equal(t_mod.alpha.detach(), torch.ones(5))
    with torch.no_grad():
        t_mod.alpha.copy_(torch.from_numpy(alpha))

    def j_loss(a):
        return j_mod.apply({"params": {"alpha": a}}, jnp.asarray(logits), jnp.asarray(labels),
                           jnp.asarray(weights))

    want, want_grad = jax.value_and_grad(j_loss)(jnp.asarray(alpha))
    got = t_mod(torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(weights))
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-6 * abs(float(want))
    np.testing.assert_allclose(t_mod.alpha.grad.numpy(), np.asarray(want_grad), rtol=1e-5,
                               atol=1e-7)
    assert FocalLoss().alpha is None


def test_binary_focal_sigmoid_matches_jax():
    rng = np.random.RandomState(3)
    logits = (rng.randn(6, 7) * 4).astype(np.float32)
    targets = (rng.rand(6, 7) > 0.5).astype(np.float32)
    for gamma, alpha in ((2.0, 0.25), (0.0, 0.5), (1.5, 0.9)):
        got = binary_focal_sigmoid(torch.from_numpy(logits), torch.from_numpy(targets), gamma,
                                   alpha).numpy()
        want = np.asarray(j_bfs(jnp.asarray(logits), jnp.asarray(targets), gamma, alpha))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_dummy_wrapper_passes_through():
    """``DummyWrapper(m)(x, labels)`` is ``m(x)``, in both packages."""
    import flax.linen as fnn

    class Dense(fnn.Module):
        @fnn.compact
        def __call__(self, x, train: bool = False):
            return fnn.Dense(2, name="fc")(x)

    rng = np.random.RandomState(4)
    x = rng.randn(3, 4).astype(np.float32)
    j_model = JDummyWrapper(model=Dense())
    variables = j_model.init(jax.random.PRNGKey(0), jnp.asarray(x))
    kernel = np.asarray(variables["params"]["model"]["fc"]["kernel"])
    bias = np.asarray(variables["params"]["model"]["fc"]["bias"])
    want = np.asarray(j_model.apply(variables, jnp.asarray(x), labels=[1, 0, 1]))
    linear = torch.nn.Linear(4, 2)
    with torch.no_grad():
        linear.weight.copy_(torch.from_numpy(kernel.T))
        linear.bias.copy_(torch.from_numpy(bias))
    got = DummyWrapper(linear)(torch.from_numpy(x), torch.tensor([1, 0, 1]), train=True)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("size,stride", [((5, 7), 8), ((3, 4), (16, 12)), ((1, 1), 4)])
def test_grid_anchors_match_jax(size, stride):
    base = generate_anchors((32.0, 64.0), (0.5, 1.0, 2.0))
    np.testing.assert_array_equal(base, j_generate_anchors((32.0, 64.0), (0.5, 1.0, 2.0)))
    got = grid_anchors(size, stride, base)
    assert got.dtype == np.float32 and got.shape == (size[0] * size[1] * 6, 4)
    np.testing.assert_array_equal(got, j_grid_anchors(size, stride, base))


def test_bbox_crop_letterbox_matches_jax():
    """Wide, tall, sub-pixel and out-of-image boxes over a batch of 4 photos
    of [0, 1] values: within 1e-4 of JAX's ``warp_perspective`` route."""
    rng = np.random.RandomState(5)
    images = rng.rand(4, 37, 53, 3).astype(np.float32)
    boxes = np.array([[4.0, 6.0, 48.0, 20.0], [10.5, 2.0, 20.0, 35.5],
                      [30.0, 30.0, 30.4, 30.2], [-10.0, 20.0, 70.0, 50.0]], np.float32)
    for out in ((24, 24), (16, 30)):
        got = bbox_crop_letterbox(torch.from_numpy(images), torch.from_numpy(boxes), out)
        want = np.asarray(j_letterbox(jnp.asarray(images), jnp.asarray(boxes), out))
        assert got.shape == want.shape == (4, *out, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
        assert (want == 0).any() and (want > 0).any()


def test_flush_scores_dump_matches_jax(tmp_path, monkeypatch):
    """The golden DB's score rows: the port's ``calc_scores`` dump, flushed to
    ``PFR_SCORES_DUMP``, holds JAX's keys, galleries and include masks, and
    its scores within 1e-6; no path or no row writes nothing."""
    jax_path, port_path = tmp_path / "jax.npz", tmp_path / "port" / "port.npz"
    monkeypatch.setenv("PFR_SCORES_DUMP", str(jax_path))
    jr._SCORES_DUMP.clear()
    try:
        for init_cards, extra_cards in _synthetic_db().values():
            jr.calc_scores(init_cards, extra_cards)
        assert jr.flush_scores_dump() == jax_path
    finally:
        jr._SCORES_DUMP.clear()
    dump = {}
    for init_cards, extra_cards in _synthetic_db().values():
        cards = [[tr.CardRecord(c.name, c.type, c.head_vectors, c.body_vectors) for c in part]
                 for part in (init_cards, extra_cards)]
        tr.calc_scores(*cards, device="cpu", dump=dump)
    monkeypatch.setenv("PFR_SCORES_DUMP", str(port_path))
    assert tr.flush_scores_dump(dump) == port_path
    with np.load(jax_path) as want, np.load(port_path) as got:
        assert sorted(got.files) == sorted(want.files) and got.files
        for key in want.files:
            if key.endswith("/scores"):
                np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(got[key], want[key])
    monkeypatch.delenv("PFR_SCORES_DUMP")
    assert tr.flush_scores_dump(dump) is None and tr.flush_scores_dump({}, port_path) is None
    assert not os.environ.get("PFR_SCORES_DUMP")
