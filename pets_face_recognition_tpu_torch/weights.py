"""Weights: the JAX package's flax variables -> the port's ``state_dict``s, and
seeded random weights.

The bridge is the inverse of the JAX package's ``utils/torch_convert.py``
(``convert_resnet``, ``convert_fe_embedder``, ``convert_detection_model``),
written again here: input is the nested ``{"params": ..., "batch_stats": ...}``
dict as numpy arrays, output uses torchvision key names. Layouts:

- conv: flax ``(kh, kw, I, O)`` -> torch ``(O, I, kh, kw)``;
- dense: ``(I, O)`` -> ``(O, I)``;
- transposed conv: flax ``(kh, kw, O, I)`` (``transpose_kernel=True``) -> torch
  ``(I, O, kh, kw)``;
- batch norm: ``scale``/``bias`` params and ``mean``/``var`` stats ->
  ``weight``/``bias``/``running_mean``/``running_var``.

The Swin trunk takes the reference's (berniwal) keys, the layout the JAX
package's ``convert_swin`` reads (:func:`swin_state_dict` is its inverse);
the ConvNeXt trunk keeps the JAX module names, its LayerNorms' ``scale`` as
``weight``. The MobileNetV3 trunk keeps the JAX module names (``stem``, ``blocks.{i}.dwconv``,
``blocks.{i}.se.fc1`` ...); its depthwise kernels ``(k, k, 1, C)`` become
``(C, 1, k, k)`` by the same conv permutation.

Given a ``params`` tree alone (``batch_stats`` absent), the same maps give the
entries of the port's trainable parameters only; a gradient tree of
``jax.grad`` has the ``params`` layout, so ``detection_state_dict({"params":
grads})`` names each JAX gradient by the port's parameter name.
"""

from __future__ import annotations

import math
import re
from typing import Mapping

import numpy as np
import torch
from torch import nn

from .losses.large_margin import MarginHead
from .models.convnext import ConvNeXtBlock
from .models.resnet import FrozenBatchNorm2d, LiveBatchNorm2d
from .models.swin import WindowAttention


def _conv(k) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _dense(k) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(k).T)


_deconv = _conv  # (kh, kw, O, I) -> (I, O, kh, kw): the same axis permutation


def _bn(sd: dict, dst: str, params: Mapping, stats: Mapping | None) -> None:
    sd[f"{dst}.weight"] = np.asarray(params["scale"])
    sd[f"{dst}.bias"] = np.asarray(params["bias"])
    if stats is None:
        return
    sd[f"{dst}.running_mean"] = np.asarray(stats["mean"])
    sd[f"{dst}.running_var"] = np.asarray(stats["var"])


def resnet_state_dict(params: Mapping, stats: Mapping | None, prefix: str = ""
                      ) -> dict[str, np.ndarray]:
    """flax ``models.resnet.ResNet`` variables -> torchvision ResNet keys (no
    ``num_batches_tracked``: the port's norms keep no counter, as flax).
    ``stats=None`` leaves out the running statistics.
    """

    def sub(tree, name):
        return None if tree is None else tree[name]

    sd: dict[str, np.ndarray] = {}
    sd["conv1.weight"] = _conv(params["conv1"]["kernel"])
    _bn(sd, "bn1", params["bn1"], sub(stats, "bn1"))
    for name in sorted(params):
        m = re.fullmatch(r"layer(\d+)_(\d+)", name)
        if not m:
            continue
        base = f"layer{m.group(1)}.{m.group(2)}"
        blk, bst = params[name], sub(stats, name)
        for c in (1, 2, 3):
            sd[f"{base}.conv{c}.weight"] = _conv(blk[f"conv{c}"]["kernel"])
            _bn(sd, f"{base}.bn{c}", blk[f"bn{c}"], sub(bst, f"bn{c}"))
        if "downsample_conv" in blk:
            sd[f"{base}.downsample.0.weight"] = _conv(blk["downsample_conv"]["kernel"])
            _bn(sd, f"{base}.downsample.1", blk["downsample_bn"],
                sub(bst, "downsample_bn"))
    if "fc" in params:
        sd["fc.weight"] = _dense(params["fc"]["kernel"])
        sd["fc.bias"] = np.asarray(params["fc"]["bias"])
    return {prefix + k: v for k, v in sd.items()}


def mobilenet_state_dict(params: Mapping, stats: Mapping | None, prefix: str = ""
                         ) -> dict[str, np.ndarray]:
    """flax ``models.mobilenet_v3.MobileNetV3Large`` variables -> the port's
    ``MobileNetV3Large`` keys (``block{i}`` -> ``blocks.{i}``; the SE convs keep
    their biases; the classifier head when present). ``stats=None`` leaves out
    the running statistics."""

    def sub(tree, name):
        return None if tree is None else tree[name]

    sd: dict[str, np.ndarray] = {}
    sd["stem.weight"] = _conv(params["stem"]["kernel"])
    _bn(sd, "bn_stem", params["bn_stem"], sub(stats, "bn_stem"))
    for name in params:
        m = re.fullmatch(r"block(\d+)", name)
        if not m:
            continue
        base, blk, bst = f"blocks.{m.group(1)}", params[name], sub(stats, name)
        for conv, bn in (("expand", "bn_expand"), ("dwconv", "bn_dw"),
                         ("project", "bn_project")):
            if conv in blk:
                sd[f"{base}.{conv}.weight"] = _conv(blk[conv]["kernel"])
                _bn(sd, f"{base}.{bn}", blk[bn], sub(bst, bn))
        if "se" in blk:
            for fc in ("fc1", "fc2"):
                _conv_pair(sd, f"{base}.se.{fc}", blk["se"][fc])
    if "head_conv" in params:
        sd["head_conv.weight"] = _conv(params["head_conv"]["kernel"])
        _bn(sd, "bn_head", params["bn_head"], sub(stats, "bn_head"))
        for fc in ("head_fc1", "head_fc2"):
            if fc in params:
                _dense_pair(sd, fc, params[fc])
    return {prefix + k: v for k, v in sd.items()}


def swin_state_dict(params: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """flax ``models.swin.SwinTransformer`` params -> the reference's (berniwal)
    keys, which the port's ``SwinTransformer`` takes: the exact inverse of the
    JAX package's ``utils/torch_convert.py::convert_swin``. LayerNorm
    ``scale`` -> ``weight``; ``block{i}_regular``/``_shifted`` ->
    ``layers.{i}.0``/``.1``; the head, when present, -> ``mlp_head.{0,1}``."""
    sd: dict[str, np.ndarray] = {}
    for sp in sorted(k for k in params if re.fullmatch(r"stage\d", k)):
        stage = params[sp]
        _dense_pair(sd, f"{sp}.patch_partition.linear", stage["patch_partition"]["linear"])
        for name, blk in stage.items():
            m = re.fullmatch(r"block(\d+)_(regular|shifted)", name)
            if not m:
                continue
            dst = f"{sp}.layers.{m.group(1)}.{int(m.group(2) == 'shifted')}"
            _bn(sd, f"{dst}.attention_block.fn.norm", blk["attn_norm"], None)
            attn = f"{dst}.attention_block.fn.fn"
            sd[f"{attn}.to_qkv.weight"] = _dense(blk["attn"]["to_qkv"]["kernel"])
            sd[f"{attn}.pos_embedding"] = np.asarray(blk["attn"]["pos_embedding"])
            _dense_pair(sd, f"{attn}.to_out", blk["attn"]["to_out"])
            _bn(sd, f"{dst}.mlp_block.fn.norm", blk["mlp_norm"], None)
            _dense_pair(sd, f"{dst}.mlp_block.fn.fn.net.0", blk["mlp_fc1"])
            _dense_pair(sd, f"{dst}.mlp_block.fn.fn.net.2", blk["mlp_fc2"])
    if "head_norm" in params:
        _bn(sd, "mlp_head.0", params["head_norm"], None)
        if "head_fc" in params:
            _dense_pair(sd, "mlp_head.1", params["head_fc"])
    return _prefixed(prefix, sd)


def convnext_state_dict(params: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """flax ``models.convnext.ConvNeXt`` params -> the port's ``ConvNeXt`` keys
    (the JAX module names; convolutions ``(O, I, kh, kw)``, the depthwise
    ``(7, 7, 1, C)`` as ``(C, 1, 7, 7)``; ``pwconv1``/``pwconv2`` and the head
    dense; LayerNorm ``scale`` -> ``weight``; ``gamma`` as is)."""
    sd: dict[str, np.ndarray] = {}
    for name, mod in params.items():
        if name in ("stem_norm", "head_norm") or name.startswith("downsample_norm"):
            _bn(sd, name, mod, None)
        elif name == "stem_conv" or name.startswith("downsample_conv"):
            _conv_pair(sd, name, mod)
        elif name == "head_fc":
            _dense_pair(sd, name, mod)
        elif re.fullmatch(r"stage\d+_block\d+", name):
            _conv_pair(sd, f"{name}.dwconv", mod["dwconv"])
            _bn(sd, f"{name}.norm", mod["norm"], None)
            _dense_pair(sd, f"{name}.pwconv1", mod["pwconv1"])
            _dense_pair(sd, f"{name}.pwconv2", mod["pwconv2"])
            sd[f"{name}.gamma"] = np.asarray(mod["gamma"])
        else:
            raise KeyError(f"convnext_state_dict: unknown module {name!r}")
    return _prefixed(prefix, sd)


def embedder_state_dict(variables: Mapping) -> dict[str, np.ndarray]:
    """flax ``EmbeddingModel`` variables -> torchvision ``resnet50`` keys with
    ``fc = Linear(2048, 512)`` (the inverse of ``convert_fe_embedder``, less
    the ``num_batches_tracked`` counters). Without ``batch_stats`` the result
    holds the trainable parameters only."""
    p, st = variables["params"], variables.get("batch_stats")
    sd = resnet_state_dict(p["backbone"], None if st is None else st["backbone"])
    sd["fc.weight"] = _dense(p["fc"]["kernel"])
    sd["fc.bias"] = np.asarray(p["fc"]["bias"])
    return sd


def fe_state_dict(variables: Mapping) -> dict[str, np.ndarray]:
    """flax ``SoftmaxBasedMetricLearning`` variables (``params`` ``model/
    backbone``, ``model/fc``, ``add_margin/weight``; ``batch_stats`` ``model/
    backbone``) -> the port's ``losses.SoftmaxBasedMetricLearning`` keys
    (``model.*``, ``add_margin.weight``; the head's ``(C, D)`` weight as is).
    A ``params`` tree alone (a gradient tree of ``jax.grad``) gives the
    trainable parameters' entries."""
    p, st = variables["params"], variables.get("batch_stats")
    sd = _prefixed("model.", embedder_state_dict(
        {"params": p["model"], **({} if st is None else {"batch_stats": st["model"]})}))
    if "add_margin" in p:
        sd["add_margin.weight"] = np.asarray(p["add_margin"]["weight"])
    return sd


def _dense_pair(sd: dict, dst: str, layer: Mapping) -> None:
    sd[f"{dst}.weight"] = _dense(layer["kernel"])
    sd[f"{dst}.bias"] = np.asarray(layer["bias"])


def _conv_pair(sd: dict, dst: str, layer: Mapping) -> None:
    sd[f"{dst}.weight"] = _conv(layer["kernel"])
    sd[f"{dst}.bias"] = np.asarray(layer["bias"])


def _prefixed(prefix: str, sd: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    return {prefix + k: v for k, v in sd.items()}


def fpn_state_dict(params: Mapping) -> dict[str, np.ndarray]:
    """flax ``FPN`` params (``inner_i``, ``layer_i``) -> ``inner_blocks.i`` /
    ``layer_blocks.i`` (flat torchvision 0.12 layout)."""
    sd: dict[str, np.ndarray] = {}
    for i in range(len([k for k in params if k.startswith("inner_")])):
        _conv_pair(sd, f"inner_blocks.{i}", params[f"inner_{i}"])
        _conv_pair(sd, f"layer_blocks.{i}", params[f"layer_{i}"])
    return sd


def rpn_head_state_dict(params: Mapping) -> dict[str, np.ndarray]:
    """flax ``RPNHead`` params -> ``conv`` / ``cls_logits`` / ``bbox_pred``."""
    sd: dict[str, np.ndarray] = {}
    for name in ("conv", "cls_logits", "bbox_pred"):
        _conv_pair(sd, name, params[name])
    return sd


def box_heads_state_dict(box_head: Mapping, box_predictor: Mapping) -> dict[str, np.ndarray]:
    """flax ``TwoMLPHead`` + ``FastRCNNPredictor`` -> ``box_head.*`` / ``box_predictor.*``."""
    sd: dict[str, np.ndarray] = {}
    for name in ("fc6", "fc7"):
        _dense_pair(sd, f"box_head.{name}", box_head[name])
    for name in ("cls_score", "bbox_pred"):
        _dense_pair(sd, f"box_predictor.{name}", box_predictor[name])
    return sd


def keypoint_heads_state_dict(params: Mapping) -> dict[str, np.ndarray]:
    """flax ``KeypointHead`` -> ``keypoint_head.{0,2,..,14}`` (conv/relu
    Sequential) and ``keypoint_predictor.kps_score_lowres``."""
    sd: dict[str, np.ndarray] = {}
    n_convs = len([k for k in params if k.startswith("kps_fcn")])
    for i in range(1, n_convs + 1):
        _conv_pair(sd, f"keypoint_head.{2 * (i - 1)}", params[f"kps_fcn{i}"])
    sd["keypoint_predictor.kps_score_lowres.weight"] = _deconv(
        params["kps_score_lowres"]["kernel"])
    sd["keypoint_predictor.kps_score_lowres.bias"] = np.asarray(
        params["kps_score_lowres"]["bias"])
    return sd


def mask_heads_state_dict(params: Mapping) -> dict[str, np.ndarray]:
    """flax ``MaskHead`` -> ``mask_head.mask_fcn{1..4}`` and
    ``mask_predictor.{conv5_mask,mask_fcn_logits}``; ``conv5_mask`` is a
    ``transpose_kernel=True`` deconv, carried over by :func:`_deconv`."""
    sd: dict[str, np.ndarray] = {}
    for i in range(1, 5):
        _conv_pair(sd, f"mask_head.mask_fcn{i}", params[f"mask_fcn{i}"])
    sd["mask_predictor.conv5_mask.weight"] = _deconv(params["conv5_mask"]["kernel"])
    sd["mask_predictor.conv5_mask.bias"] = np.asarray(params["conv5_mask"]["bias"])
    _conv_pair(sd, "mask_predictor.mask_fcn_logits", params["mask_fcn_logits"])
    return sd


def detection_state_dict(variables: Mapping) -> dict[str, np.ndarray]:
    """flax ``GeneralizedRCNN`` variables -> torchvision keypoint or Mask R-CNN
    keys in the flat (torchvision 0.12) layout (the inverse of ``convert_detection_model``).
    The trunk is read from the tree: ``stem`` is MobileNetV3 (the port's
    MobileNetV3 keys), ``stem_conv`` ConvNeXt (:func:`convnext_state_dict`),
    ``stage1`` with a ``patch_partition`` Swin (:func:`swin_state_dict`),
    anything else ResNet. Without ``batch_stats`` the result holds the
    trainable parameters only; with them, live-BN and frozen MobileNetV3
    detectors load it alike."""
    p, st = variables["params"], variables.get("batch_stats")
    body, prefix = p["backbone"]["backbone"], "backbone.body."
    if "stem_conv" in body:
        sd = convnext_state_dict(body, prefix)
    elif "patch_partition" in body.get("stage1", {}):
        sd = swin_state_dict(body, prefix)
    else:
        trunk = mobilenet_state_dict if "stem" in body else resnet_state_dict
        sd = trunk(body, None if st is None else st["backbone"]["backbone"], prefix=prefix)
    sd.update(_prefixed("backbone.fpn.", fpn_state_dict(p["backbone"]["fpn"])))
    sd.update(_prefixed("rpn.head.", rpn_head_state_dict(p["rpn"])))
    sd.update(_prefixed("roi_heads.", box_heads_state_dict(p["box_head"],
                                                           p["box_predictor"])))
    if "mask_head" in p:
        sd.update(_prefixed("roi_heads.", mask_heads_state_dict(p["mask_head"])))
    if "keypoint_head" in p:
        sd.update(_prefixed("roi_heads.", keypoint_heads_state_dict(p["keypoint_head"])))
    return sd


_TV_NESTED = ((re.compile(r"^backbone\.fpn\.(inner|layer)_blocks\.(\d+)\.0\."),
               r"backbone.fpn.\1_blocks.\2."),
              (re.compile(r"^rpn\.head\.conv\.0\.0\."), "rpn.head.conv."),
              (re.compile(r"^roi_heads\.mask_head\.(\d+)\.0\."),
               lambda m: f"roi_heads.mask_head.mask_fcn{int(m.group(1)) + 1}."))


def torchvision_keypoint_state_dict(sd: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    """A torchvision ``keypointrcnn_resnet50_fpn`` or ``maskrcnn_resnet50_fpn``
    ``state_dict`` (numpy arrays) -> the port's keys and layouts.

    The port's box head flattens the NHWC pooled block in ``(h, w, c)``
    order, as the JAX ``TwoMLPHead`` does; torchvision's ``fc6`` takes NCHW
    ``(c, h, w)`` columns. So ``roi_heads.box_head.fc6.weight``'s columns are
    permuted ``(c, h, w) -> (h, w, c)``: loaded as is, they would feed the
    head permuted inputs. The nested FPN and RPN names of torchvision >= 0.13
    (``inner_blocks.0.0.weight``, ``rpn.head.conv.0.0.weight``,
    ``mask_head.{i-1}.0.weight``) become the flat ones (``mask_fcn{i}``);
    ``num_batches_tracked`` counters are dropped (the port's
    detection norms keep none). Every other tensor is copied unchanged.
    """
    out: dict[str, np.ndarray] = {}
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        for pat, repl in _TV_NESTED:
            k = pat.sub(repl, k)
        out[k] = np.asarray(v)
    w = out["roi_heads.box_head.fc6.weight"]
    n_out, n_in = w.shape
    c = n_in // 49
    if c * 49 != n_in:
        raise ValueError(f"fc6 takes {n_in} inputs, not a multiple of 7 x 7")
    out["roi_heads.box_head.fc6.weight"] = np.ascontiguousarray(
        w.reshape(n_out, c, 7, 7).transpose(0, 2, 3, 1).reshape(n_out, n_in))
    return out


# the Mask R-CNN reader is the same function: the mask head's names are its own
torchvision_maskrcnn_state_dict = torchvision_keypoint_state_dict


def _quant_leaves(tree: Mapping, path: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _quant_leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _quant_module_name(path: tuple[str, ...], rpn_levels: list[str]) -> str:
    """A JAX module path of the ``quant`` collection -> the port's module name."""
    out = []
    for part in path:
        if m := re.fullmatch(r"layer(\d+)_(\d+)", part):        # a trunk bottleneck
            out.append(f"layer{m.group(1)}.{m.group(2)}")
        elif part == "downsample_conv":
            out.append("downsample.0")
        elif m := re.fullmatch(r"(inner|layer)_q(\d+)", part):  # FPN quant points
            out.append(f"{m.group(1)}_q.{m.group(2)}")
        elif m := re.fullmatch(r"(inner|layer)_(\d+)", part):   # FPN convs
            out.append(f"{m.group(1)}_blocks.{m.group(2)}")
        elif m := re.fullmatch(r"conv_q_(\w+)", part):         # RPN, one a level
            out.append(f"conv_q.{rpn_levels.index(m.group(1))}")
        elif m := re.fullmatch(r"kps_q(\d+)", part):
            out.append(f"kps_q.{int(m.group(1)) - 1}")
        elif m := re.fullmatch(r"kps_fcn(\d+)", part):
            out.append(str(2 * (int(m.group(1)) - 1)))
        else:
            out.append(part)
    return ".".join(out)


def quant_state_dict(quant: Mapping, kind: str = "detection") -> dict[str, np.ndarray]:
    """A JAX ``quant`` collection (numpy leaves: ``scale`` and ``seen`` of each
    ``ActQuant``, ``kernel_q`` HWIO int8 and ``w_scale`` of each
    ``QuantConv``) -> the port's quant buffers (``scale``, ``seen``,
    ``weight_q`` OIHW, ``w_scale``) by ``state_dict`` name, for ``kind``:

    - ``"detection"``: a ``GeneralizedRCNN`` (``backbone/backbone`` ->
      ``backbone.body``, ``backbone/fpn`` -> ``backbone.fpn``, ``rpn`` ->
      ``rpn.head`` with ``conv_q_{lvl}`` in level order, ``keypoint_head``
      -> ``roi_heads.keypoint_head``);
    - ``"embedder"``: an ``EmbeddingModel`` (``backbone`` -> the port's
      ``EmbeddingModel``, a ResNet itself);
    - ``"resnet"``: a bare ``ResNet``.
    """
    roots = {"detection": {"backbone": {"backbone": "backbone.body", "fpn": "backbone.fpn"},
                           "rpn": "rpn.head", "keypoint_head": "roi_heads.keypoint_head"},
             "embedder": {"backbone": ""}, "resnet": None}[kind]
    rpn_levels = sorted(k[len("conv_q_"):] for k in quant.get("rpn", {})
                        if k.startswith("conv_q_"))
    sd: dict[str, np.ndarray] = {}
    for path, leaf in _quant_leaves(quant):
        root, rest = roots, list(path)
        while isinstance(root, Mapping):
            root = root[rest.pop(0)]
        name = ".".join(p for p in (root, _quant_module_name(tuple(rest[:-1]), rpn_levels)) if p)
        buf = {"kernel_q": "weight_q"}.get(rest[-1], rest[-1])
        value = _conv(leaf) if buf == "weight_q" else np.asarray(leaf)
        sd[f"{name}.{buf}"] = value
    return sd


def to_tensors(sd: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


@torch.no_grad()
def init_random_(module: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights, in place, drawn on the CPU from one generator.

    Weights are ``N(0, 1) / sqrt(fan_in)`` (keeps a random 50-layer forward
    finite), biases zero, norms near identity: ``weight ~ U(0.5, 1.5)``,
    ``bias ~ 0.1 N``, ``running_mean ~ 0.1 N``, ``running_var ~ U(0.5, 1.5)``
    (LayerNorms the same affine); a margin head's ``(C, D)`` weight
    xavier-uniform, as flax initialises it; Swin's ``pos_embedding`` N(0, 1),
    as flax initialises it; ConvNeXt's layer scale ``gamma`` U(0.5, 1.5), not
    flax's 1e-6, at which every block is the identity to float32 precision.
    """
    g = torch.Generator().manual_seed(seed)

    def draw(t: torch.Tensor, fn) -> None:
        t.copy_(fn(t.shape).to(t))

    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = m.weight
            fan_in = w.shape[0] * math.prod(w.shape[2:]) if isinstance(
                m, nn.ConvTranspose2d) else math.prod(w.shape[1:])
            draw(w, lambda s: torch.randn(s, generator=g) / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, LiveBatchNorm2d, FrozenBatchNorm2d)):
            draw(m.weight, lambda s: torch.rand(s, generator=g) + 0.5)
            draw(m.bias, lambda s: torch.randn(s, generator=g) * 0.1)
            draw(m.running_mean, lambda s: torch.randn(s, generator=g) * 0.1)
            draw(m.running_var, lambda s: torch.rand(s, generator=g) + 0.5)
        elif isinstance(m, nn.LayerNorm):
            draw(m.weight, lambda s: torch.rand(s, generator=g) + 0.5)
            draw(m.bias, lambda s: torch.randn(s, generator=g) * 0.1)
        elif isinstance(m, WindowAttention):
            draw(m.pos_embedding, lambda s: torch.randn(s, generator=g))
        elif isinstance(m, ConvNeXtBlock):
            draw(m.gamma, lambda s: torch.rand(s, generator=g) + 0.5)
        elif isinstance(m, MarginHead):
            bound = math.sqrt(6.0 / sum(m.weight.shape))
            draw(m.weight, lambda s: (torch.rand(s, generator=g) * 2 - 1) * bound)
    return module


def retrieval_state_dicts(detector_vars: Mapping, dog_vars: Mapping, cat_vars: Mapping,
                          ) -> tuple[dict[str, torch.Tensor], ...]:
    """The JAX head retrieval chain's variables -> ``(detector, dog embedder,
    cat embedder)`` ``state_dict``s for ``pipelines.build_retrieval_models``'
    modules: one keypoint R-CNN and two ``EmbeddingModel``s."""
    return (to_tensors(detection_state_dict(detector_vars)),
            to_tensors(embedder_state_dict(dog_vars)),
            to_tensors(embedder_state_dict(cat_vars)))
