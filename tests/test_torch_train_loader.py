"""The port's TrainLoader (point_teacher_torch.data.loader) and training logger
(point_teacher_torch.utils.logging) against the JAX package's, on small
datasets written in the real on-disk layouts: an AI-TOD-style COCO json whose
images fall in both aspect groups (so the group sampler's draws are used),
and a SODA-A divData folder of per-patch jsons. Batches must be bit-equal
(image, boxes, labels, valid, ids, dtypes included) over two epochs from the
same seed, with the image normalisation on and off."""
import json
import os
import re

import numpy as np
import pytest
from PIL import Image

from point_teacher_tpu import data as jdata
from point_teacher_tpu.data.loader import TrainLoader as JaxTrainLoader
from point_teacher_tpu.data.sodaa import SODAADataset as JaxSODAA
from point_teacher_tpu.evalx.rgeometry import obb2poly_np
from point_teacher_tpu.utils import logging as jlogging
from point_teacher_torch import data as pdata
from point_teacher_torch.utils import logging as plogging
from torch_port_env import port_test_module  # noqa: F401 (autouse)

AITOD_CLASSES = ("airplane", "bridge", "storage-tank", "ship", "swimming-pool", "vehicle",
                 "person", "wind-mill")
NORM = dict(mean=(123.675, 116.28, 103.53), std=(58.395, 57.12, 57.375), to_rgb=True)
FIELDS = ("image", "gt_boxes", "gt_labels", "gt_valid", "image_ids")


def write_coco(root, n_images, seed=0, sizes=((64, 64),), n_empty=0, max_boxes=8,
               side=(2.0, 10.0)):
    """An AI-TOD-layout set: images/<i>.png of random pixels (sizes (w, h)
    taken in turn) and one COCO json with the 8 AI-TOD class names, 1 to
    max_boxes boxes of `side` px an image (the last n_empty images none).
    Returns (annotation file, image folder)."""
    r = np.random.RandomState(seed)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    images, anns = [], []
    for i in range(n_images):
        w, h = sizes[i % len(sizes)]
        name = f"{i:04d}.png"
        Image.fromarray(r.randint(0, 255, (h, w, 3)).astype(np.uint8)).save(
            os.path.join(img_dir, name))
        images.append(dict(id=i + 1, file_name=name, width=w, height=h))
        for _ in range(0 if i >= n_images - n_empty else r.randint(1, max_boxes + 1)):
            bw, bh = r.uniform(*side, 2)
            x, y = r.uniform(0, w - bw), r.uniform(0, h - bh)
            anns.append(dict(id=len(anns) + 1, image_id=i + 1, category_id=int(r.randint(1, 9)),
                             bbox=[float(x), float(y), float(bw), float(bh)], iscrowd=0))
    ann_file = os.path.join(root, "ann.json")
    with open(ann_file, "w") as f:
        json.dump(dict(images=images, annotations=anns,
                       categories=[dict(id=i + 1, name=n) for i, n in enumerate(AITOD_CLASSES)]),
                  f)
    return ann_file, img_dir + "/"


def write_sodaa_patches(root, n_patches, size=64, seed=0, n_empty=1, max_boxes=8):
    """A SODA-A divData split: Annotations/<name>.json (8-point polygons,
    category ids 0-8) and Images/<name>.jpg (PNG pixels under the name the
    dataset reads), named as data/patch.py names patches; the last n_empty
    patches hold no box (the training set drops them). Returns (annotation
    folder, image folder)."""
    r = np.random.RandomState(seed)
    ann_dir, img_dir = os.path.join(root, "Annotations"), os.path.join(root, "Images")
    os.makedirs(ann_dir, exist_ok=True)
    os.makedirs(img_dir, exist_ok=True)
    for i in range(n_patches):
        name = f"scene{i // 4}__{size}__{(i % 2) * size // 2}___{(i // 2 % 2) * size // 2}"
        Image.fromarray(r.randint(0, 255, (size, size, 3)).astype(np.uint8)).save(
            os.path.join(img_dir, name + ".jpg"), format="PNG")
        n = 0 if i >= n_patches - n_empty else r.randint(1, max_boxes + 1)
        boxes = np.concatenate([r.uniform(8, size - 8, (n, 2)), r.uniform(4, 12, (n, 2)),
                                r.uniform(-1.5, 1.5, (n, 1))], -1)
        with open(os.path.join(ann_dir, name + ".json"), "w") as f:
            json.dump(dict(annotations=[
                dict(poly=[float(v) for v in p], category_id=int(r.randint(0, 9)))
                for p in obb2poly_np(boxes).reshape(-1, 8)]), f)
    return ann_dir + "/", img_dir + "/"


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    """11 images: 64 x 48 and 48 x 64 in turn (both aspect groups), the last
    two without a box (dropped as empty): groups of 5 and 4 images, batches
    of 2 leave a tail of 1 in the first."""
    return write_coco(str(tmp_path_factory.mktemp("coco")), 11, seed=1,
                      sizes=((64, 48), (48, 64)), n_empty=2)


@pytest.fixture(scope="module")
def sodaa_dir(tmp_path_factory):
    return write_sodaa_patches(str(tmp_path_factory.mktemp("sodaa")), 8, seed=2)


def _assert_epochs_equal(ploader, jloader, epochs=2):
    n_batches = []
    for _ in range(epochs):
        got, want = list(ploader.epoch()), list(jloader.epoch())
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for k in FIELDS:
                a, b = g[k], np.asarray(getattr(w, k))
                assert a.dtype == b.dtype and a.shape == b.shape, k
                np.testing.assert_array_equal(a, b, err_msg=k)
        n_batches.append([g["image_ids"].tolist() for g in got])
    return n_batches


@pytest.mark.parametrize("img_norm", [None, NORM], ids=["raw", "img_norm"])
def test_train_loader_matches_jax_coco(coco_dir, img_norm):
    """Both aspect groups: a permutation a group, the tail dropped, the
    batches shuffled; two epochs from seed 3."""
    ann, prefix = coco_dir
    pds, jds = pdata.AITODDataset(ann, prefix), jdata.AITODDataset(ann, prefix)
    assert len(pds) == len(jds) == 9
    ploader = pdata.TrainLoader(pds, 2, 6, 64, seed=3, img_norm=img_norm)
    jloader = JaxTrainLoader(jds, 2, 6, 64, seed=3, img_norm=img_norm)
    assert ploader.groups is not None and [len(g) for g in ploader.groups] == [4, 5]
    order = _assert_epochs_equal(ploader, jloader)
    assert len(order[0]) == 4 and order[0] != order[1]   # 2 + 2 batches, reshuffled


@pytest.mark.parametrize("img_norm", [None, NORM], ids=["raw", "img_norm"])
def test_train_loader_matches_jax_sodaa(sodaa_dir, img_norm):
    """One aspect group (square patches, and SODAADataset has no img_infos):
    one permutation an epoch over the 7 patches with boxes, the tail of 1
    dropped."""
    ann, prefix = sodaa_dir
    pds, jds = pdata.SODAADataset(ann, prefix), JaxSODAA(ann, prefix)
    assert len(pds) == len(jds) == 7
    ploader = pdata.TrainLoader(pds, 2, 6, 64, seed=4, img_norm=img_norm)
    jloader = JaxTrainLoader(jds, 2, 6, 64, seed=4, img_norm=img_norm)
    assert ploader.groups is None
    order = _assert_epochs_equal(ploader, jloader)
    assert len(order[0]) == 3


def test_train_loader_raises_a_worker_error(coco_dir):
    """A failure in the prefetch thread reaches the consumer."""
    ann, prefix = coco_dir
    ds = pdata.AITODDataset(ann, prefix + "missing/")
    with pytest.raises(FileNotFoundError):
        next(pdata.TrainLoader(ds, 2, 6, 64).epoch())


def _drive_logger(mod, work_dir):
    """One metric stream through a TrainLogger of `mod` at interval 3: seven
    steps over two epochs (the first ends at step 5), a val record at each
    epoch's end."""
    logger = mod.TrainLogger(str(work_dir), interval=3)
    r = np.random.RandomState(0)
    for step in range(1, 8):
        epoch = 1 if step <= 5 else 2
        logger.step(step, epoch, {"loss_cls": r.rand(), "total_loss": r.rand() * 3,
                                  "coarse_iou": r.rand()}, lr=0.01 * step)
        if step in (5, 7):
            logger.emit(step, epoch, lr=0.5)
            logger.val(step, epoch, {"val_mAP": r.rand()}, lr=0.25)
    logger.emit(7, 2)   # nothing buffered: no record
    with open(os.path.join(work_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_logger_matches_jax(tmp_path, capsys):
    want = _drive_logger(jlogging, tmp_path / "jax")
    jout = capsys.readouterr().out
    got = _drive_logger(plogging, tmp_path / "port")
    pout = capsys.readouterr().out
    assert got == want
    assert [r["mode"] for r in got] == ["train", "train", "val", "train", "train", "val"]
    assert [r["iter"] for r in got] == [3, 5, 5, 6, 7, 7]
    no_time = lambda s: re.sub(r"time: [0-9.]+s/it", "time", s)  # noqa: E731
    assert no_time(pout) == no_time(jout)
    assert pout.splitlines()[0].startswith("Epoch [1] Iter [3] lr: 3.00e-02, time: ")


def test_log_buffer_matches_jax():
    pb, jb = plogging.LogBuffer(), jlogging.LogBuffer()
    for m in ({"a": 1.0, "b": 2}, {"a": 3.5}, {"b": np.float32(0.25)}):
        pb.update(m)
        jb.update(m)
    assert pb.averages() == jb.averages() == {"a": 2.25, "b": 1.125}
    pb.clear()
    assert pb.averages() == {}
