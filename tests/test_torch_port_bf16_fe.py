"""Feature-extractor training and evaluation in the JAX package's reduced
precision, on the CPU: ``build_fe_config(compute_dtype=...)`` and its
``"auto"`` default, one FE step of the port's bfloat16 embedder (live
BatchNorm, ArcFace s 64 m 0.5, the focal loss, the FE SGD in three groups)
against JAX's at ``dtype=jnp.bfloat16`` on the same weights and batch, an
``eval_fe`` batch in bfloat16, and a checkpoint of the bfloat16 step loaded
by ``eval_fe.predict`` into a bfloat16 model.

Rounding points (JAX ``build_fe_config(compute_dtype="bfloat16")``): the
trunk's convolutions in bfloat16, live BatchNorm's statistics and output in
float32 (``resnet.py:226-236``), ``fc`` in float32 (``embedder.py:30``), the
margin head's cosine in float32 (``large_margin.py:31,49-51``), parameters
and optimiser state float32. bfloat16's own move is the distance of each
bfloat16 step from the port's float32 step, the port's or JAX's, whichever
is larger (the port's float32 step stands for JAX's: ``test_torch_port_fe_
train.py`` holds the two within JAX's own spread); each tensor is held to
JAX's within twice that move plus the float32 step's tolerance. Sizes as
``test_torch_port_fe_train.py``: one bottleneck a stage at full width, a
512-d embedding, B = 4 crops of 64 x 64, C = 8 classes.
"""

import inspect
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pets_face_recognition_tpu.config_presets import build_fe_config as j_build_fe_config
from pets_face_recognition_tpu.losses import SoftmaxBasedMetricLearning as JWrapper
from pets_face_recognition_tpu.models import embedder as j_embedder
from pets_face_recognition_tpu.models import resnet as j_resnet
from pets_face_recognition_tpu.utils.optim import fe_sgd_optimizer as j_sgd
from pets_face_recognition_tpu_torch import eval_fe, smoke_data, weights
from pets_face_recognition_tpu_torch.config_presets import (build_fe_config,
                                                            resolve_compute_dtype)
from pets_face_recognition_tpu_torch.engine.checkpoint import save_checkpoint
from pets_face_recognition_tpu_torch.engine.controller import Controller
from pets_face_recognition_tpu_torch.losses import SoftmaxBasedMetricLearning
from pets_face_recognition_tpu_torch.models import layers
from pets_face_recognition_tpu_torch.models.embedder import resnet50_embedder
from pets_face_recognition_tpu_torch.utils import DictWrapper, get_config
from pets_face_recognition_tpu_torch.utils.optim import fe_sgd_optimizer

from test_torch_port_bf16_train import BF16_LOSS, DRAWS, JITTER, _dist, held
from test_torch_port_models import randomize

torch.set_num_threads(1)

STAGES = (1, 1, 1, 1)
B, IMG, C, D = 4, 64, 8, 512
LR = 1e-2
# the float32 step's tolerance (test_torch_port_fe_train.py) of the
# parameters after SGD, 1e-5; gradients are ill-conditioned in float32 (ReLU
# inputs within 1e-4 of 0 flip), so their floor is bfloat16's step, 2^-8; the
# loss's is BF16_LOSS, half a bfloat16 step of its value
F32_GRAD, F32_PARAM = 2.0 ** -8, 1e-5
# an eval batch through a bfloat16 chain: relative L2 (test_torch_port_bf16_models.py)
CHAIN_L2 = 2e-2


def port_wrapper(dtype, variables) -> SoftmaxBasedMetricLearning:
    model = SoftmaxBasedMetricLearning(resnet50_embedder(D, stage_sizes=STAGES, dtype=dtype),
                                       D, C)
    model.load_state_dict(weights.to_tensors(weights.fe_state_dict(variables)), strict=True)
    return model


def port_run(model, batch) -> dict:
    """The port's FE step of the wrapper ``model`` on ``batch``: the metrics,
    eval embeddings before the step, gradients, parameters and buffers after
    it, and the float32 margin logits."""
    ctl = Controller(DictWrapper({"optimizer": lambda c: partial(fe_sgd_optimizer, lr=LR)}))
    state = ctl.init_state(0, "cpu", model=model)
    emb = ctl.make_eval_step()(state, torch.from_numpy(batch["x"]))
    metrics = ctl.train_step(state, batch)
    return dict(metrics=metrics, emb=emb,
                grads={n: p.grad.clone() for n, p in model.named_parameters()},
                params={n: p.detach().clone() for n, p in model.named_parameters()},
                buffers={n: b.clone() for n, b in model.named_buffers()},
                logits=model.train()(torch.from_numpy(batch["x"]),
                                     torch.from_numpy(batch["label"]).long())["logits"])


@pytest.fixture(scope="module")
def steps():
    rng = np.random.RandomState(3)
    batch = {"x": rng.rand(B, IMG, IMG, 3).astype(np.float32),
             "label": rng.randint(0, C, B).astype(np.int32),
             "index": np.arange(B, dtype=np.int32)}
    # resnet50_embedder(dtype=bfloat16) cut to one bottleneck a stage
    j_model = JWrapper(model=j_embedder.EmbeddingModel(
        backbone=j_resnet.ResNet(stage_sizes=STAGES, dtype=jnp.bfloat16), embedding_dim=D,
        dtype=jnp.bfloat16), emb_size=D, num_classes=C, margin_type="arc", use_focal=True)
    x, labels = jnp.asarray(batch["x"]), jnp.asarray(batch["label"])
    variables = randomize(jax.eval_shape(j_model.init, jax.random.PRNGKey(0), x, labels),
                          np.random.RandomState(23))
    variables = jax.tree.map(np.asarray, variables)

    def loss_fn(p, x):
        out, mut = j_model.apply({"params": p, "batch_stats": variables["batch_stats"]}, x,
                                 labels, train=True, mutable=["batch_stats"])
        return out["loss"], (out, mut["batch_stats"])

    j_step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    tx = j_sgd(LR)
    j_update = jax.jit(tx.update)
    # bfloat16's own move: JAX's bfloat16 step against the port's float32
    # one on the batch and on DRAWS copies with each pixel jittered below
    # bfloat16's resolution (test_torch_port_bf16_train.py)
    jittered = np.random.RandomState(24)
    draws = []
    for r in range(DRAWS + 1):
        b = dict(batch, x=batch["x"] * (1 + JITTER * jittered.uniform(
            -1, 1, batch["x"].shape)).astype(np.float32) if r else batch["x"])
        (_, (j_out, j_stats)), j_grads = j_step(variables["params"], jnp.asarray(b["x"]))
        updates, _ = j_update(j_grads, tx.init(variables["params"]), variables["params"])
        j_new = jax.tree.map(lambda p, u: p + u, variables["params"], updates)
        j_grads = weights.fe_state_dict({"params": j_grads})
        j_new = weights.fe_state_dict({"params": j_new, "batch_stats": j_stats})
        f32 = port_run(port_wrapper(torch.float32, variables), b)
        new32 = dict(f32["params"], **f32["buffers"])
        draws.append(({"loss": abs(float(j_out["loss"]) - f32["metrics"]["loss"])},
                      {n: _dist(g, f32["grads"][n])[0] for n, g in j_grads.items()},
                      {n: _dist(t, new32[n])[0] for n, t in j_new.items()}))
        if r == 0:
            want = dict(j_out=j_out, j_grads=j_grads, j_new=j_new)
            runs = {torch.float32: f32}
    own_moves = [{k: max(d[i][k] for d in draws) for k in draws[0][i]} for i in range(3)]
    runs[torch.bfloat16] = port_run(port_wrapper(torch.bfloat16, variables), batch)
    j_emb = jax.jit(lambda v, x: j_model.apply(v, x, train=False))(variables, x)
    return dict(runs=runs, own_moves=own_moves, j_emb=j_emb, variables=variables,
                batch=batch, **want)


def test_auto_resolves_by_the_device_not_the_card():
    """``"auto"`` is float32 for the CPU and bfloat16 for a CUDA device, whether
    or not this machine has a card; the explicit names are taken as given."""
    assert resolve_compute_dtype("auto", "cpu") == torch.float32
    assert resolve_compute_dtype("auto", torch.device("cpu")) == torch.float32
    for dev in ("cuda", "cuda:1", torch.device("cuda", 0)):
        assert resolve_compute_dtype("auto", dev) == torch.bfloat16
    for dev in ("cpu", "cuda"):
        assert resolve_compute_dtype("float32", dev) == torch.float32
        assert resolve_compute_dtype("bfloat16", dev) == torch.bfloat16
    with pytest.raises(ValueError, match="compute_dtype"):
        resolve_compute_dtype("float16", "cpu")


def test_build_fe_config_compute_dtype(tmp_path):
    """JAX's argument order and default; the config's embedder in bfloat16 for a
    CUDA device (built on the CPU, no card needed) and float32 for the CPU under
    ``"auto"``, as JAX's ``"auto"`` on its CPU backend; explicit dtypes on both;
    the controller builds for the device it is given."""
    names = list(inspect.signature(build_fe_config).parameters)
    assert names == list(inspect.signature(j_build_fe_config).parameters)
    assert inspect.signature(build_fe_config).parameters["compute_dtype"].default == "auto"
    smoke_data.make_fe(tmp_path, n_ids=6, n_imgs=3, size=32)
    kw = dict(dataset_dir=str(tmp_path / "smoke_fe_cats"), num_workers=0, n_pairs=10)

    def trunk_dtype(embedder):
        assert embedder.fc.compute_dtype == torch.float32
        assert {p.dtype for p in embedder.parameters()} == {torch.float32}
        return embedder.conv1.compute_dtype

    auto = build_fe_config(output=str(tmp_path / "auto"), **kw)
    want = j_build_fe_config(output=str(tmp_path / "jax"), **kw)
    assert want["model"]().dtype == jnp.float32          # JAX on its CPU backend
    assert trunk_dtype(auto["model"](device="cpu")) == torch.float32
    assert trunk_dtype(auto["model"](device="cuda")) == torch.bfloat16
    ctl = Controller(DictWrapper(auto))
    assert trunk_dtype(ctl.build_model("cuda").model) == torch.bfloat16
    assert trunk_dtype(ctl.build_model("cpu").model) == torch.float32
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        cfg = build_fe_config(output=str(tmp_path / name), compute_dtype=name, **kw)
        j_cfg = j_build_fe_config(output=str(tmp_path / f"j{name}"), compute_dtype=name, **kw)
        assert cfg["compute_dtype"] == name and j_cfg["model"]().dtype == jnp.dtype(name)
        assert trunk_dtype(cfg["model"](device="cpu")) == dtype
        assert trunk_dtype(cfg["model"](device="cuda")) == dtype


def test_bf16_fe_step_matches_jax(steps):
    """The loss within twice bfloat16's own move; ``train_acc`` is the share of
    rows whose float32 margin logits' argmax is the label."""
    bf = steps["runs"][torch.bfloat16]
    want = float(steps["j_out"]["loss"])
    assert np.isfinite(bf["metrics"]["loss"])
    assert held(bf["metrics"]["loss"], want, steps["own_moves"][0]["loss"], BF16_LOSS) <= 1.0
    assert bf["logits"].dtype == torch.float32
    assert bf["metrics"]["train_acc"] in {i / B for i in range(B + 1)}


def gradient_ratios(steps, grads) -> dict[str, float]:
    return {n: held(g, steps["j_grads"][n], steps["own_moves"][1][n], F32_GRAD)
            for n, g in grads.items()}


def test_bf16_fe_step_gradients_and_update_match_jax(steps):
    """Every gradient and every parameter after SGD, float32, and the live-BN
    running statistics (float32: batch statistics of float32 norms) within
    twice bfloat16's own move."""
    bf, f32 = steps["runs"][torch.bfloat16], steps["runs"][torch.float32]
    assert sorted(bf["grads"]) == sorted(steps["j_grads"])
    assert all(g.dtype == torch.float32 for g in bf["grads"].values())
    worst = gradient_ratios(steps, bf["grads"])
    name = max(worst, key=worst.get)
    assert worst[name] <= 1.0, (name, worst[name])
    assert any(not torch.equal(g, f32["grads"][n]) for n, g in bf["grads"].items())
    for kind in ("params", "buffers"):
        for n, p in bf[kind].items():
            assert p.dtype == torch.float32, n
            assert held(p, steps["j_new"][n], steps["own_moves"][2][n], F32_PARAM) <= 1.0, (
                kind, n)


def test_bf16_fe_gradient_check_rejects_a_planted_fault(steps):
    """A bfloat16 step whose trunk passes back twice the cotangent of its last
    stage fails the gradient check."""
    def doubled(mod, inp, y):
        if y.requires_grad:
            y.register_hook(lambda g: 2 * g)

    model = port_wrapper(torch.bfloat16, steps["variables"])
    model.model.layer4.register_forward_hook(doubled)
    faulty = port_run(model, steps["batch"])
    assert max(gradient_ratios(steps, faulty["grads"]).values()) > 1.0


def test_bf16_eval_batch_matches_jax(steps):
    """``make_eval_step`` on the bfloat16 wrapper (running statistics, the
    trunk in bfloat16, ``fc`` in float32): float32 embeddings within the chain
    tolerance of JAX's ``train=False`` embeddings."""
    emb = steps["runs"][torch.bfloat16]["emb"]
    want = np.asarray(steps["j_emb"], np.float64)
    assert emb.dtype == torch.float32 and emb.shape == want.shape
    err = np.linalg.norm(emb.numpy() - want) / np.linalg.norm(want)
    assert err <= CHAIN_L2, err


CONFIG = """from pets_face_recognition_tpu_torch.config_presets import (build_fe_config,
                                                            resolve_compute_dtype)
from pets_face_recognition_tpu_torch.models.embedder import resnet50_embedder

globals().update(build_fe_config(dataset_dir={data!r}, train_batch_size=4, test_batch_size=4,
                                 crop=30, size=32,
                                 num_workers=0, output={out!r}, n_pairs=10,
                                 compute_dtype="bfloat16"))


def model(device="cuda"):
    return resnet50_embedder(512, stage_sizes=(1, 1, 1, 1),
                             dtype=resolve_compute_dtype(compute_dtype, device))
"""


def test_bf16_checkpoint_loads_into_eval_fe(tmp_path):
    """A checkpoint of a bfloat16 step holds float32 parameters and statistics,
    and ``eval_fe.predict`` loads it into the config's bfloat16 embedder: its
    embeddings are those of the trained wrapper's own eval step, bit for bit."""
    smoke_data.make_fe(tmp_path, n_ids=6, n_imgs=3, size=32)
    path = tmp_path / "fe_bf16.py"
    path.write_text(CONFIG.format(data=str(tmp_path / "smoke_fe_cats"), out=str(tmp_path)))
    ctl = Controller(get_config(path))
    state = ctl.init_state(0, "cpu")
    assert state.model.model.conv1.compute_dtype == torch.bfloat16
    batch = next(iter(ctl.train_dataloader()))
    ctl.train_step(state, batch)
    ckpt = save_checkpoint(tmp_path / "ckpt", state, 0)
    saved = torch.load(ckpt, map_location="cpu", weights_only=False)
    floats = [t for t in _tensors(saved) if t.is_floating_point()]
    assert floats and all(t.dtype == torch.float32 for t in floats)
    _, outputs = eval_fe.predict(path, ckpt, device="cpu")
    val = next(iter(ctl.val_dataloader()))
    want = ctl.make_eval_step()(state, torch.from_numpy(np.asarray(val["x"])))
    assert torch.equal(torch.from_numpy(outputs[0]["emb"]), want)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
