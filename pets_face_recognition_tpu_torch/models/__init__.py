"""Models of the serving path (counterparts of the JAX ``models/``)."""

from .convnext import ConvNeXt, convnext_small, convnext_tiny
from .mobilenet_v3 import MobileNetV3Large, mobilenet_v3_large
from .rcnn import (convnetx_tiny_rcnn, convnext_tiny_keypoint_rcnn, fasterrcnn_resnet50_fpn,
                   keypointrcnn_resnet50_fpn, maskrcnn_resnet50_fpn, mobile_net_v3_large_rcnn,
                   mobile_net_v3_large_keypoint_rcnn, swin_tiny_keypoint_rcnn)
from .resnet import BasicBlock, Bottleneck, ResNet, resnet18, resnet34, resnet50
from .swin import SwinTransformer, swin_b, swin_l, swin_s, swin_t

__all__ = ["BasicBlock", "Bottleneck", "ConvNeXt", "MobileNetV3Large", "ResNet",
           "SwinTransformer", "convnetx_tiny_rcnn", "convnext_small", "convnext_tiny",
           "convnext_tiny_keypoint_rcnn", "fasterrcnn_resnet50_fpn", "keypointrcnn_resnet50_fpn",
           "maskrcnn_resnet50_fpn", "mobile_net_v3_large_keypoint_rcnn",
           "mobile_net_v3_large_rcnn", "mobilenet_v3_large", "resnet18", "resnet34", "resnet50",
           "swin_b", "swin_l", "swin_s", "swin_t", "swin_tiny_keypoint_rcnn"]
