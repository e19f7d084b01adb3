"""Evaluation batches (the port's counterpart of point_teacher_tpu/data/loader.py
EvalLoader): host decode and resize, fixed-shape numpy batches."""
from __future__ import annotations

import numpy as np

from .pipeline import preprocess


class EvalLoader:
    """Yields (image indices, images [B, canvas, canvas, 3], scale_factors
    [B, 4], img_shapes [B, 2]) in dataset order; the tail batch is padded to
    B with blank images (scale 1, the canvas as shape), which the caller
    drops by the length of the indices."""

    def __init__(self, dataset, batch_size: int, canvas: int = 800, img_norm=None):
        self.ds = dataset
        self.batch_size = batch_size
        self.canvas = canvas
        self.img_norm = img_norm

    def __iter__(self):
        n = len(self.ds)
        for start in range(0, n, self.batch_size):
            idxs = list(range(start, min(start + self.batch_size, n)))
            imgs, scales, shapes = [], [], []
            for i in idxs:
                img, _, scale, shape = preprocess(
                    self.ds.image_path(i), None, self.canvas,
                    img_norm=self.img_norm, return_shape=True)
                imgs.append(img)
                scales.append(scale)
                shapes.append(shape)
            while len(imgs) < self.batch_size:
                imgs.append(np.zeros_like(imgs[0]))
                scales.append(np.ones(4, np.float32))
                shapes.append(np.asarray([self.canvas, self.canvas], np.float32))
            yield idxs, np.stack(imgs), np.stack(scales), np.stack(shapes)
