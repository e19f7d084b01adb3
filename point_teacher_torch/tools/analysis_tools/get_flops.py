"""FLOPs and parameters of the port's detector (counterpart of
tools/analysis_tools/get_flops.py).

  python -m point_teacher_torch.tools.analysis_tools.get_flops CONFIG [--shape 800] [--cpu]

Counts the FLOPs of one forward of the config's detector (apis.init_detector,
the seeded init: the count does not depend on the weights) on a
[1, shape, shape, 3] image with torch.utils.flop_counter.FlopCounterMode,
and its parameters (every tensor of model.parameters(), the frozen BN
statistics included, as the JAX package's params tree holds them).

FlopCounterMode counts the matrix products only: convolutions, mm / addmm /
bmm and attention, 2 FLOPs per multiply-add. The JAX tool reads XLA's cost
analysis of the compiled forward, which also counts the elementwise work
(BN affine, ReLU, additions, upsampling, GroupNorm, sigmoid and the head's
decode): the two numbers measure different things and are not comparable.
Runs on the CUDA card unless --cpu is given; asked for CUDA without a card it
raises.
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Detector FLOPs and parameters (PyTorch port)")
    ap.add_argument("config")
    ap.add_argument("--shape", type=int, default=800)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap.parse_args(argv)


def main(argv=None):
    """Returns (FLOPs, parameter count)."""
    args = parse_args(argv)
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ...apis import init_detector

    det = init_detector(args.config, device="cpu" if args.cpu else None)
    img = torch.zeros((1, args.shape, args.shape, 3), device=det.device)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        det.model(img)
    flops = counter.get_total_flops()
    n_params = sum(p.numel() for p in det.model.parameters())
    print(f"Input shape: (1, {args.shape}, {args.shape}, 3)")
    print(f"Flops: {flops / 1e9:.2f} GFLOPs (convolutions and matrix products, "
          f"2 a multiply-add)")
    print(f"Params: {n_params / 1e6:.2f} M ({n_params})")
    return flops, n_params


if __name__ == "__main__":
    main()
