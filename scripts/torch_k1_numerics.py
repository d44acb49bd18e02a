#!/usr/bin/env python3
"""How far the float K1's similarities lie from float64, on one NVIDIA GPU.

    python3 scripts/torch_k1_numerics.py [--seed 0]

Why the float K1 (csrc/match_top2.cu) forms its similarities with f32
FMAs and not in 3xTF32 on the tensor cores: 3xTF32 splits every f32 value x
into hi = rna_tf32(x) and lo = rna_tf32(x - hi) and sums lo1*hi2 + hi1*lo2 +
hi1*hi2 over k in an f32 accumulator, and chip_smoke.py holds the kernel to
the plain f32 matmul at SIM_ATOL = 1e-6. This script measures, against the
float64 product of the same unit descriptors (chip_smoke._k1_case, the
phase-4 inputs):

  * the plain f32 matmul (TF32 off), the kernel's yardstick;
  * one TF32 product of the raw values (what 3xTF32 avoids);
  * 3xTF32 emulated through the tensor cores by cuBLAS: the three terms laid
    side by side along k, 8 values at a time (lo1*hi2, hi1*lo2, hi1*hi2), as
    one K = 384 TF32 product (one f32 accumulator, as one `wgmma` chain
    would hold it); with the big and the small terms in two products summed
    in f32; and with a fresh accumulator every 4 and every 1 k steps, the
    partial products summed in f32 (round to nearest) in k order;
  * match_top2 itself: its best similarity s1 against
    the float64 similarity of the same (row, column), and against the plain
    f32 version's s1.

Each line gives the largest absolute error over the whole matrix and over
the best column of every row (the values near 1 that the ratio test reads),
the mean signed error there (a bias shows an accumulator that truncates),
and the largest difference from the plain f32 matmul: the quantity that
chip_smoke.py holds to SIM_ATOL. The first line is the card's name and
power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SHAPES = (("duplicates-free 1024x2048", dict(B=1, N1=1024, N2=2048)),
          ("matcher chunk B=4 cap 2048", dict(B=4, N1=2048, N2=2048, n_lo=1500, n_hi=2048)),
          ("one pair 8192x8192", dict(B=1, N1=8192, N2=8192)))


def rna_tf32(x):
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as `cvt.rna.tf32.f32`: add half of the dropped range to the
    magnitude bits and clear them (finite values)."""
    import torch

    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def interleave(parts):
    """[..., N, 128] parts -> [..., N, 128 * len(parts)]: for each 8-deep k
    step, the parts' 8 values one after another."""
    import torch

    n = parts[0].shape[:-1]
    return torch.stack([p.reshape(*n, 16, 8) for p in parts], dim=-2).reshape(*n, 128 * len(parts))


def grouped(a, b, steps):
    """sum over groups of `steps` k steps of a [.., N1, K] x b [.., N2, K]^T,
    each group one TF32 product, the groups added in f32 in k order."""
    width = 24 * steps
    out = None
    for k0 in range(0, a.shape[-1], width):
        part = a[..., k0 : k0 + width] @ b[..., k0 : k0 + width].mT
        out = part if out is None else out + part
    return out


def report(label, sim, ref, best, plain):
    import torch

    err = (sim.double() - ref)
    at_best = torch.gather(err, -1, best[..., None])[..., 0]
    print(f"[numerics] {label}: max |err| {float(err.abs().max()):.3g} over the matrix, "
          f"{float(at_best.abs().max()):.3g} at the best columns (mean signed "
          f"{float(at_best.mean()):.3g}); max |sim - plain f32| {float((sim - plain).abs().max()):.3g}",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke
    from colmap_pcd_tpu_torch.ops import match_kernel

    if not torch.cuda.is_available():
        raise SystemExit("torch_k1_numerics: needs an NVIDIA GPU")
    print(f"[env] nvidia-smi: {chip_smoke._nvidia_smi()}", flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    for name, shape in SHAPES:
        d1, d2, v1, v2 = (torch.as_tensor(x, device=dev) for x in chip_smoke._k1_case(rng, **shape))
        ref = d1.double() @ d2.double().mT
        best = torch.argmax(torch.where(v2[..., None, :] > 0, ref, torch.full_like(ref, -2.0)), -1)
        torch.backends.cuda.matmul.allow_tf32 = False
        plain = d1 @ d2.mT
        report(f"{name}, plain f32 matmul", plain, ref, best, plain)
        (h1, l1), (h2, l2) = split(d1), split(d2)
        a3, b3 = interleave((l1, h1, h1)), interleave((h2, l2, h2))
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            report(f"{name}, 1xTF32", d1 @ d2.mT, ref, best, plain)
            report(f"{name}, 3xTF32 one accumulator (lo*hi, hi*lo, hi*hi per k step)",
                   a3 @ b3.mT, ref, best, plain)
            report(f"{name}, 3xTF32 big and small terms in two products",
                   h1 @ h2.mT + interleave((l1, h1)) @ interleave((h2, l2)).mT, ref, best, plain)
            for steps in (4, 1):
                report(f"{name}, 3xTF32 a fresh accumulator every {steps} k step(s)",
                       grouped(a3, b3, steps), ref, best, plain)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        s1, _, idx = match_kernel.match_top2(d1, d2, v2)
        r1, _, _ = match_kernel.match_top2_reference(d1, d2, v2)
        at = torch.gather(ref, -1, idx.long()[..., None])[..., 0]
        e = s1.double() - at
        print(f"[numerics] {name}, match_top2 s1: max |err| against float64 {float(e.abs().max()):.3g} "
              f"(mean signed {float(e.mean()):.3g}), against the plain f32 version "
              f"{float((s1 - r1).abs().max()):.3g}", flush=True)
        del ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
