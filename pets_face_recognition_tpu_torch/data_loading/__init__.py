"""Data loading of the port (counterpart of the JAX ``data_loading/``): the
identity datasets and pair sampler of the feature extractor, the CAT landmark
datasets, rot90 of boxes and keypoints, and the thread-pool loader. Images
decode with the port's ``native/`` routes (JPEG, PNG), never PIL."""

from .dataset import (ConcatDataset, RecDataset, RecSubset, SimpleDataset, check_dir,
                      check_images, init_dataset, rot90_boxes, rot90_keypoints,
                      simple_init_dataset)
from .lmd_dataset import CatLMDDataset, CatLMDSubset
from .loader import DataLoader, default_collate
from .pairs import PairGenerator

__all__ = ["CatLMDDataset", "CatLMDSubset", "ConcatDataset", "DataLoader", "PairGenerator",
           "RecDataset", "RecSubset", "SimpleDataset", "check_dir", "check_images", "default_collate",
           "init_dataset", "rot90_boxes", "rot90_keypoints", "simple_init_dataset"]
