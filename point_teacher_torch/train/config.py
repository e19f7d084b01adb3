"""Static training configuration (the port's own copy of
point_teacher_tpu/train/config.py; defaults mirror the AI-TOD-v2 0% config).

The fields both training phases read, HBB and OBB, and the test-time
settings (`test`).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

from ..core.proposals import FineProposalCfg
from ..core.pseudo import FuseAssignerCfg
from ..core.synthetic import SynCfg
from .dense_losses import DenseLossCfg

# per synthetic class (w, h, dw, dr): the prior size and the log-normal spreads
DEFAULT_SHAPE_LIST = (
    (20, 20, 0.5, 0.5), (10, 20, 0.5, 0.5), (30, 80, 0.5, 0.5),
    (20, 50, 0.5, 0.5), (30, 120, 0.5, 0.5), (30, 40, 0.5, 0.5),
)
SODAA_SHAPE_LIST = (
    (20, 20, 0.5, 0.5), (10, 20, 0.5, 0.5), (10, 30, 0.5, 0.5),
    (40, 20, 0.5, 0.5), (30, 10, 0.5, 0.5),
    (20, 50, 0.5, 0.5), (30, 20, 0.5, 0.5), (35, 40, 0.6, 0.5),
)


class OptimCfg(NamedTuple):
    base_lr: float = 0.005
    momentum: float = 0.9
    weight_decay: float = 1e-4
    bias_lr_mult: float = 2.0
    grad_clip_norm: float = 35.0
    warmup_iters: int = 10000
    warmup_ratio: float = 1.0 / 3
    step_epochs: Tuple[int, ...] = (8, 11)
    max_epochs: int = 12
    iters_per_epoch: int = 5000
    frozen_stages: int = 1  # stem + layer1 (+ all FrozenBN regardless)
    bn_affine_trainable: bool = False  # OBB config: norm requires_grad=True


class InferenceCfg(NamedTuple):
    nms_pre: int = 3000
    score_thr: float = 0.05
    nms_iou: float = 0.5
    max_per_img: int = 3000


class PointTeacherConfig(NamedTuple):
    # data/shapes
    num_classes: int = 8
    img_size: int = 800
    max_gt: int = 100
    batch_size: int = 2
    # teacher-student
    ema_alpha: float = 0.999
    burn_in_step: int = 4000
    lamda: float = 1.0
    position: float = 0.0
    filter_score: float = 0.0
    # MIL
    num_stages: int = 1
    top_k: int = 1
    beta: float = 0.25
    alpha: Tuple[float, float] = (0.01, 0.25)  # (mil_bbox, mil_bags) weights
    num_training_burninstep1: int = 100
    num_training_burninstep2: int = 100
    dn_hyper_denoising: float = 0.2
    # Bag pooling: the grouped window pool clamps each member's samples into
    # a `mil_pool_window`-cell window around its group centre (the reference
    # default); False pools every roi over the whole map. Both run through
    # the one RoIAlign kernel (clamp bounds).
    mil_pool_grouped: bool = True
    mil_pool_window: int = 24          # HBB group window (feature cells)
    mil_pool_window_rotated: int = 16  # rotated group / per-roi window
    fine_proposal_cfg: Tuple[FineProposalCfg, ...] = (
        FineProposalCfg(base_ratios=(1.0,), shake_ratio=None, min_scale=0.0, gen_num_neg=200),
        FineProposalCfg(base_ratios=(1.0,), shake_ratio=None, min_scale=4.0, gen_num_neg=200),
    )
    fine_proposal_extensive_cfg: Tuple[FineProposalCfg, ...] = (
        FineProposalCfg(base_ratios=(1.0, 1.2, 1.3, 0.8, 0.7), shake_ratio=None, min_scale=4.0),
        FineProposalCfg(base_ratios=(1.0, 1.2, 1.3, 0.8, 0.7), shake_ratio=(0.1,), min_scale=16.0),
    )
    # synthetic (phase 1)
    syn_fill_value: float = 255.0  # paint value of the masked regions
    shape_list: Tuple[Tuple[float, float, float, float], ...] = DEFAULT_SHAPE_LIST
    # assigners / losses
    fuse_assigner: FuseAssignerCfg = FuseAssignerCfg(
        num_pre=5, topk=3, cls_weight=1.0, reg_weight=1.0, insider_weight=1.0)
    dense: DenseLossCfg = DenseLossCfg()
    # runtime
    optim: OptimCfg = OptimCfg()
    test: InferenceCfg = InferenceCfg()
    stride: int = 8

    @property
    def syn_cfg(self) -> SynCfg:
        return SynCfg(shape_list=self.shape_list, imgsize=self.img_size)

    def normalized(self) -> "PointTeacherConfig":
        """Propagate top-level fields into nested sub-configs."""
        return self._replace(dense=self.dense._replace(num_classes=self.num_classes))

    @property
    def feat_size(self) -> int:
        return self.img_size // self.stride


def config_0pct(**overrides) -> PointTeacherConfig:
    """aitodv2_point_teacher_0%.py equivalent (centre points)."""
    return PointTeacherConfig(**overrides)


def _noisy_proposals():
    fine = (
        FineProposalCfg(base_ratios=(1.0,), shake_ratio=None, min_scale=0.0, gen_num_neg=200),
        FineProposalCfg(base_ratios=(1.0,), shake_ratio=None, min_scale=4.0, gen_num_neg=200),
    )
    ext = (
        FineProposalCfg(base_ratios=(1.0, 1.2, 1.3, 1.4, 0.8, 0.7, 0.6),
                        shake_ratio=None, min_scale=4.0),
        FineProposalCfg(base_ratios=(1.0, 1.2, 1.3, 0.8, 0.7), shake_ratio=(0.1,),
                        min_scale=16.0),
    )
    return fine, ext


def config_sodaa(**overrides) -> PointTeacherConfig:
    """sodaa_fcos_pointteacher_1x.py equivalent: 9 classes, 1200 px patches,
    burn_in 8000, centre points, top_k 3, rotated test NMS iou 0.1,
    nms_pre / max_per_img 2000, trainable BN affine."""
    fine = FineProposalCfg(base_ratios=(1.0,), shake_ratio=None, min_scale=0.0, gen_num_neg=200)
    base = dict(
        num_classes=9,
        img_size=1200,
        burn_in_step=8000,
        position=0.0,
        top_k=3,
        fine_proposal_cfg=(fine, fine),
        fine_proposal_extensive_cfg=(
            FineProposalCfg(base_ratios=(1.0, 1.2, 1.3, 0.8, 0.6), shake_ratio=None,
                            min_scale=4.0),
            FineProposalCfg(base_ratios=(1.0, 1.3, 0.8), shake_ratio=None, min_scale=4.0),
        ),
        shape_list=SODAA_SHAPE_LIST,
        test=InferenceCfg(nms_pre=2000, score_thr=0.05, nms_iou=0.1, max_per_img=2000),
        optim=OptimCfg(bn_affine_trainable=True),
    )
    base.update(overrides)
    return PointTeacherConfig(**base)


def config_noisy(position: float, **overrides) -> PointTeacherConfig:
    """30/60/100% random-point configs: lamda=0.5, 75 training GTs, wider bags."""
    fine, ext = _noisy_proposals()
    base = dict(position=position, lamda=0.5, num_training_burninstep1=75,
                num_training_burninstep2=75,
                fine_proposal_cfg=fine, fine_proposal_extensive_cfg=ext)
    base.update(overrides)
    return PointTeacherConfig(**base)
