"""COCO-format detection datasets (the port's own copy of
point_teacher_tpu/data/coco.py: pure python json parsing, no pycocotools).

Capability targets:
- CocoDataset (HBB_TOD/mmdet/datasets/coco.py): annotation loading, category
  id -> contiguous label mapping, empty-image filtering, xywh -> xyxy.
- AITODDataset (HBB_TOD/mmdet/datasets/aitod.py:21): the 8 AI-TOD-v2 classes,
  evaluation at IoU 0.25 with vt/t/s/m size buckets (see evalx.cocoeval).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np


class CocoDetDataset:
    CLASSES: Sequence[str] = ()

    def __init__(
        self,
        ann_file: str,
        img_prefix: str = "",
        classes: Optional[Sequence[str]] = None,
        filter_empty: bool = True,
        min_size: Optional[int] = None,
    ):
        if classes is not None:
            self.CLASSES = tuple(classes)
        self.ann_file = ann_file
        self.img_prefix = img_prefix
        with open(ann_file) as f:
            coco = json.load(f)

        name_to_cat = {c["name"]: c["id"] for c in coco.get("categories", [])}
        if not self.CLASSES:
            self.CLASSES = tuple(c["name"] for c in coco.get("categories", []))
        # classes absent from the json are tolerated (label index keeps its
        # position in CLASSES, so checkpoints stay comparable across splits)
        self.cat_ids = [name_to_cat.get(n) for n in self.CLASSES]
        self.cat2label: Dict[int, int] = {
            cid: i for i, cid in enumerate(self.cat_ids) if cid is not None
        }

        anns_by_img: Dict[int, List[dict]] = {}
        for a in coco.get("annotations", []):
            anns_by_img.setdefault(a["image_id"], []).append(a)

        self.img_infos: List[dict] = []
        self.annotations: List[dict] = []
        for img in coco.get("images", []):
            anns = anns_by_img.get(img["id"], [])
            boxes, labels = [], []
            for a in anns:
                if a.get("iscrowd", 0) or a["category_id"] not in self.cat2label:
                    continue
                x, y, w, h = a["bbox"]
                if w < 1 or h < 1:
                    continue
                boxes.append([x, y, x + w, y + h])
                labels.append(self.cat2label[a["category_id"]])
            if filter_empty and not boxes:
                continue
            self.img_infos.append(img)
            self.annotations.append(
                dict(
                    boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
                    labels=np.asarray(labels, np.int64),
                )
            )

    def __len__(self):
        return len(self.img_infos)

    def image_path(self, idx: int) -> str:
        return os.path.join(self.img_prefix, self.img_infos[idx]["file_name"])

    def get_ann(self, idx: int) -> dict:
        return self.annotations[idx]

    def coco_gt(self) -> dict:
        """Ground truth in the layout evalx.cocoeval consumes."""
        return dict(
            img_ids=[img["id"] for img in self.img_infos],
            classes=list(self.CLASSES),
            annotations=[
                dict(boxes=a["boxes"], labels=a["labels"]) for a in self.annotations
            ],
        )


class AITODDataset(CocoDetDataset):
    CLASSES = (
        "airplane", "bridge", "storage-tank", "ship",
        "swimming-pool", "vehicle", "person", "wind-mill",
    )


class VisDroneDataset(CocoDetDataset):
    """HBB_TOD/mmdet/datasets visdrone variant class list."""

    CLASSES = (
        "pedestrian", "people", "bicycle", "car", "van", "truck",
        "tricycle", "awning-tricycle", "bus", "motor",
    )


class XViewDataset(CocoDetDataset):
    """xView COCO-converted variant (60 classes in the full set; the tiny-
    object splits used by the reference keep the COCO json's categories —
    classes come from the json)."""

    CLASSES = ()


class DOTADataset(CocoDetDataset):
    """DOTA-v2 HBB COCO-converted variant."""

    CLASSES = (
        "plane", "baseball-diamond", "bridge", "ground-track-field",
        "small-vehicle", "large-vehicle", "ship", "tennis-court",
        "basketball-court", "storage-tank", "soccer-ball-field", "roundabout",
        "harbor", "swimming-pool", "helicopter", "container-crane",
        "airport", "helipad",
    )


class SODADDataset(CocoDetDataset):
    """SODA-D (HBB small-object) variant."""

    CLASSES = (
        "people", "rider", "bicycle", "motor", "vehicle",
        "traffic-sign", "traffic-light", "traffic-camera", "warning-cone",
    )
