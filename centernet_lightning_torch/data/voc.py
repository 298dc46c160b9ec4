"""Pascal-VOC detection dataset (XML annotations; a copy of the JAX
package's data/voc.py, with OpenCV imported only when an image is read).

Reimplements the reference VOCDataset (reference datasets/voc.py:50-109):
split list from ImageSets/Main/{split}.txt, XML parse with coordinate
clamping, name -> label mapping. Internal format: pixel xywh.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Callable, Dict, List, Optional

import numpy as np

__all__ = ["VOCDataset", "process_voc_xml", "VOC_CLASSES"]

VOC_CLASSES = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]


def process_voc_xml(path: str, name_to_label: Dict[str, int]):
    """Parse one VOC XML. Returns (boxes xywh pixels, labels); coordinates
    clamped to the image like the reference (voc.py:10-48)."""
    root = ET.parse(path).getroot()
    size = root.find("size")
    img_w = int(size.find("width").text)
    img_h = int(size.find("height").text)

    boxes, labels = [], []
    for obj in root.iter("object"):
        name = obj.find("name").text
        if name not in name_to_label:
            continue
        bb = obj.find("bndbox")
        x1 = max(0.0, float(bb.find("xmin").text))
        y1 = max(0.0, float(bb.find("ymin").text))
        x2 = min(float(img_w), float(bb.find("xmax").text))
        y2 = min(float(img_h), float(bb.find("ymax").text))
        if x2 - x1 <= 1 or y2 - y1 <= 1:
            continue
        boxes.append([x1, y1, x2 - x1, y2 - y1])
        labels.append(name_to_label[name])
    return boxes, labels


class VOCDataset:
    def __init__(
        self,
        data_dir: str,
        split: str = "train",
        transforms: Optional[Callable] = None,
        class_names: Optional[List[str]] = None,
        name_to_label: Optional[Dict[str, int]] = None,
    ):
        self.data_dir = data_dir
        self.transforms = transforms
        if name_to_label:
            # the Gen-A config spelling (reference configs/helmet.yaml:24-26:
            # name_to_label: {person: 0, hat: 1}). Labels may be sparse —
            # size the class axis by the LARGEST label, not the mapping
            # length, or out-of-range labels silently vanish from the
            # scatter-rendered heatmap targets
            self.name_to_label = dict(name_to_label)
            labels = list(self.name_to_label.values())
            if min(labels) < 0:
                raise ValueError(f"name_to_label has a negative label: "
                                 f"{self.name_to_label}")
            names = [f"class_{i}" for i in range(max(labels) + 1)]
            for n, i in self.name_to_label.items():
                names[i] = n
            self.class_names = names
        else:
            self.class_names = class_names or VOC_CLASSES
            self.name_to_label = {n: i for i, n in enumerate(self.class_names)}
        self.num_classes = len(self.class_names)

        split_file = os.path.join(data_dir, "ImageSets", "Main", f"{split}.txt")
        with open(split_file) as f:
            self.ids = [line.split()[0] for line in f if line.strip()]

    def __len__(self) -> int:
        return len(self.ids)

    def num_annotations(self, idx: int) -> int:
        """Box count from the XML alone — no image decode (used by
        DetectionForTracking to assign synthetic track-id ranges without
        reading every JPEG at construction time)."""
        _, labels = process_voc_xml(
            os.path.join(self.data_dir, "Annotations", f"{self.ids[idx]}.xml"),
            self.name_to_label,
        )
        return len(labels)

    def __getitem__(self, idx: int) -> Dict:
        name = self.ids[idx]
        path = os.path.join(self.data_dir, "JPEGImages", f"{name}.jpg")
        import cv2

        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(f"cannot read image {path}")
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        boxes, labels = process_voc_xml(
            os.path.join(self.data_dir, "Annotations", f"{name}.xml"),
            self.name_to_label,
        )
        sample = {
            "image": img,
            "bboxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "labels": np.asarray(labels, np.int64),
            "image_id": idx,
        }
        if self.transforms is not None:
            image_id = sample.pop("image_id")
            sample = self.transforms(sample)
            sample["image_id"] = image_id
        return sample
