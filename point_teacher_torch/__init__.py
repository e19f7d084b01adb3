"""PyTorch/CUDA port of Point-Teacher (training of both forks; the HBB
fork's inference and eval).

The JAX package `point_teacher_tpu` is the reference this package is held
against, function by function. This package imports neither JAX nor the
reference package. Public functions keep the reference's layouts (NHWC
features, xyxy boxes in image pixels) so both can be fed the same inputs.
"""
