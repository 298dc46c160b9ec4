"""Data (port of data/): the dataset readers, transforms, collate, the
threaded loader and the builder, numpy and OpenCV only; OpenCV is imported
only where an image is read or warped, so the package loads without it."""
from . import transforms
from .builder import (DATASETS, build_dataloader, build_dataset,
                      loader_from_config, parse_transforms)
from .coco import CocoDetection, load_coco_annotations
from .collate import CollateDetection, CollateTracking
from .crowdhuman import CrowdHumanDataset
from .detection_for_tracking import DetectionForTracking
from .inference import InferenceDataset
from .kitti import KITTITrackingDataset, KITTITrackingSequence
from .loader import DataLoader
from .mosaic import MosaicDataset
from .mot import MOTTrackingDataset, MOTTrackingSequence
from .transforms import Compose, build_transforms
from .voc import VOCDataset

__all__ = ["DATASETS", "CocoDetection", "CollateDetection", "CollateTracking",
           "Compose", "CrowdHumanDataset", "DataLoader",
           "DetectionForTracking", "InferenceDataset", "KITTITrackingDataset",
           "KITTITrackingSequence", "MOTTrackingDataset", "MOTTrackingSequence",
           "MosaicDataset", "VOCDataset", "build_dataloader", "build_dataset",
           "build_transforms", "load_coco_annotations", "loader_from_config",
           "parse_transforms", "transforms"]
