"""Data loading of the port (counterpart of the JAX ``data_loading/``): the
CAT landmark datasets, rot90 of boxes and keypoints, and the thread-pool
loader. Images decode with the port's ``native/`` JPEG route, never PIL."""

from .dataset import ConcatDataset, rot90_boxes, rot90_keypoints
from .lmd_dataset import CatLMDDataset, CatLMDSubset
from .loader import DataLoader, default_collate

__all__ = ["CatLMDDataset", "CatLMDSubset", "ConcatDataset", "DataLoader",
           "default_collate", "rot90_boxes", "rot90_keypoints"]
