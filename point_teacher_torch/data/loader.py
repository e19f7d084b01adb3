"""Batch loaders (the port's counterpart of point_teacher_tpu/data/loader.py):
host decode and resize into fixed-shape numpy batches, the training batches
made by a background prefetch thread.

TrainLoader draws its order as the JAX package's does, from one
np.random.RandomState(seed): a permutation a epoch, or, when the dataset's
images fall in both aspect groups (w / h > 1 and not), a permutation a group
cut into batches and the batches shuffled (mmdet's GroupSampler); the tail
that does not fill a batch is dropped. The batches' image_ids are the
dataset indices, which index the point caches. The batches stay numpy: the
caller moves them to the device.

In a world of ranks (parallel/dist.py) both loaders split each global
batch: every rank draws the same order, and reads and decodes only its
rows (dist.rank_rows) of each batch; a world that does not divide the
batch size raises ValueError.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from ..parallel import dist
from .pipeline import pad_gts, preprocess


class TrainLoader:
    def __init__(self, dataset, batch_size: int, max_gt: int, canvas: int = 800,
                 seed: int = 0, prefetch: int = 2, group_by_aspect: bool = True,
                 img_norm=None):
        self.ds = dataset
        self.batch_size = batch_size
        self.max_gt = max_gt
        self.canvas = canvas
        self.rng = np.random.RandomState(seed)
        self.prefetch = prefetch
        self.img_norm = img_norm
        self.rows = dist.rank_rows(batch_size)
        # GroupSampler: batches drawn within aspect groups (a no-op for the
        # square AI-TOD images and SODA-A patches, which fall in one group;
        # SODAADataset has no img_infos)
        self.groups = None
        if group_by_aspect and hasattr(dataset, "img_infos"):
            flags = np.asarray([1 if info.get("width", 1) / max(info.get("height", 1), 1) > 1
                                else 0 for info in dataset.img_infos])
            if len(np.unique(flags)) > 1:
                self.groups = [np.nonzero(flags == v)[0] for v in (0, 1)]

    def _make_batch(self, idxs) -> dict:
        imgs, boxes_l, labels_l, valid_l = [], [], [], []
        for i in idxs:
            ann = self.ds.get_ann(i)
            img, boxes, _ = preprocess(self.ds.image_path(i), ann["boxes"], self.canvas,
                                       img_norm=self.img_norm)
            b, l, v = pad_gts(boxes, ann["labels"], self.max_gt)
            imgs.append(img)
            boxes_l.append(b)
            labels_l.append(l)
            valid_l.append(v)
        return dict(image=np.stack(imgs), gt_boxes=np.stack(boxes_l),
                    gt_labels=np.stack(labels_l), gt_valid=np.stack(valid_l),
                    image_ids=np.asarray(idxs, np.int32))

    def _chunks(self):
        bs = self.batch_size
        if self.groups is None:
            order = self.rng.permutation(len(self.ds))
            n = (len(order) // bs) * bs
            return [order[i:i + bs] for i in range(0, n, bs)]
        chunks = []
        for grp in self.groups:
            order = self.rng.permutation(grp)
            n = (len(order) // bs) * bs
            chunks += [order[i:i + bs] for i in range(0, n, bs)]
        self.rng.shuffle(chunks)
        return chunks

    def epoch(self) -> Iterator[dict]:
        """One epoch's batches, dicts of numpy arrays (image [B, S, S, 3]
        f32, gt_boxes [B, G, 4 or 5], gt_labels [B, G] int32, gt_valid
        [B, G] bool, image_ids [B] int32; in a world of N ranks this rank's
        B / N rows of each), made `prefetch` ahead by a thread, in the drawn
        order. The order is drawn when the epoch starts."""
        chunks = [c[self.rows] for c in self._chunks()]
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def worker():
            try:
                for c in chunks:
                    q.put(self._make_batch(c))
            except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
                q.put(e)
            q.put(stop)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, BaseException):
                raise item
            yield item


class EvalLoader:
    """Yields (image indices, images [B, canvas, canvas, 3], scale_factors
    [B, 4], img_shapes [B, 2]) in dataset order; the tail batch is padded to
    B with blank images (scale 1, the canvas as shape), which the caller
    drops by the length of the indices. In a world of N ranks the arrays
    hold this rank's B / N rows of each batch, the indices the whole batch's."""

    def __init__(self, dataset, batch_size: int, canvas: int = 800, img_norm=None):
        self.ds = dataset
        self.batch_size = batch_size
        self.canvas = canvas
        self.img_norm = img_norm
        self.rows = dist.rank_rows(batch_size)

    def __iter__(self):
        n = len(self.ds)
        for start in range(0, n, self.batch_size):
            idxs = list(range(start, min(start + self.batch_size, n)))
            imgs, scales, shapes = [], [], []
            for i in idxs[self.rows]:
                img, _, scale, shape = preprocess(
                    self.ds.image_path(i), None, self.canvas,
                    img_norm=self.img_norm, return_shape=True)
                imgs.append(img)
                scales.append(scale)
                shapes.append(shape)
            while len(imgs) < self.rows.stop - self.rows.start:
                imgs.append(np.zeros((self.canvas, self.canvas, 3), np.float32))
                scales.append(np.ones(4, np.float32))
                shapes.append(np.asarray([self.canvas, self.canvas], np.float32))
            yield idxs, np.stack(imgs), np.stack(scales), np.stack(shapes)
