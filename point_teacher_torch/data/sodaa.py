"""SODA-A dataset: per-patch JSON annotations with 8-point polygons (the
port's own copy of point_teacher_tpu/data/sodaa.py).

Capability target: SODAADataset (OBB_TOD/mmrotate/datasets/sodaa.py):
- per-patch json files (one per image patch) whose 'annotations' carry
  'poly' (8 values) + 'category_id' (0-indexed);
- patch filenames encode their offset in the original image
  ('name__SIZE__X___Y.jpg');
- a parallel folder of original-image jsons is the merged-eval ground truth;
- poly -> (cx, cy, w, h, a) via min-area rect (le90).
"""
from __future__ import annotations

import glob
import json
import os
from typing import Iterator, List, Optional

import numpy as np

from ..evalx.rgeometry import poly2obb_np


def _read_folder(folder: str) -> Iterator[dict]:
    """Each non-empty json of `folder` in name order, as dict(filename (the
    json's name with .jpg), boxes [G, 5] le90, labels [G])."""
    for ann_file in sorted(glob.glob(os.path.join(folder, "*.json"))):
        if os.path.getsize(ann_file) == 0:
            continue
        with open(ann_file) as f:
            data = json.load(f)
        boxes, labels = [], []
        for ann in data.get("annotations", []):
            poly = np.asarray(ann["poly"], np.float32)
            if len(poly) > 8:
                continue  # reference neglects >4-corner polygons
            obb = poly2obb_np(poly)
            if obb is None:
                continue
            boxes.append(obb)
            labels.append(int(ann["category_id"]))
        yield dict(filename=os.path.basename(ann_file).replace(".json", ".jpg"),
                   boxes=np.asarray(boxes, np.float32).reshape(-1, 5),
                   labels=np.asarray(labels, np.int64))


class SODAADataset:
    CLASSES = (
        "airplane", "helicopter", "small-vehicle", "large-vehicle",
        "ship", "container", "storage-tank", "swimming-pool", "windmill",
    )

    def __init__(self, ann_folder: str, img_prefix: str = "",
                 ori_ann_folder: Optional[str] = None, filter_empty: bool = True):
        self.img_prefix = img_prefix
        self.infos: List[dict] = [i for i in _read_folder(ann_folder)
                                  if len(i["boxes"]) or not filter_empty]
        self.ori_infos = list(_read_folder(ori_ann_folder)) if ori_ann_folder else None

    def __len__(self):
        return len(self.infos)

    def image_path(self, idx: int) -> str:
        return os.path.join(self.img_prefix, self.infos[idx]["filename"])

    def get_ann(self, idx: int) -> dict:
        return self.infos[idx]

    def ori_gt(self) -> dict:
        """Merged-image ground truth for sodaa_evaluate."""
        if self.ori_infos is None:
            raise ValueError("ori_ann_folder not provided")
        return dict(
            img_ids=[i["filename"] for i in self.ori_infos],
            classes=list(self.CLASSES),
            annotations=[dict(boxes=i["boxes"], labels=i["labels"])
                         for i in self.ori_infos],
        )
