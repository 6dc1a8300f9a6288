#!/usr/bin/env python
"""Compare our 7-spheres render against the reference's own published
showcase image (/root/reference/showcase/7-spheres.png — the Zig
tracer's 1000x1000 x 1000spp output, README.md:49-61).

RNG streams differ (Zig xoroshiro vs PCG4D), so agreement is statistical:
at 1000 spp the per-pixel MC noise is ~sigma/sqrt(1000); systematic
differences (wrong geometry/material/texture/gamma) would dwarf it.

    python tools/compare_reference.py ours.png theirs.png
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from zraytrace_tpu.io.png import decode_png  # noqa: E402


def load(p):
    with open(p, "rb") as f:
        return decode_png(f.read())[..., :3].astype(np.float64)


def main():
    ours = load(sys.argv[1])
    theirs = load(sys.argv[2] if len(sys.argv) > 2
                  else "/root/reference/showcase/7-spheres.png")
    assert ours.shape == theirs.shape, (ours.shape, theirs.shape)
    diff = ours - theirs
    ad = np.abs(diff)
    print(f"shape                {ours.shape}")
    print(f"mean |diff| (8-bit)  {ad.mean():.3f}")
    print(f"median |diff|        {np.median(ad):.3f}")
    print(f"p99 |diff|           {np.percentile(ad, 99):.3f}")
    print(f"max |diff|           {ad.max():.0f}")
    print(f"mean signed diff     {diff.mean():+.3f}")
    print(f"frac |diff| > 8      {(ad > 8).mean():.4f}")
    print(f"frac |diff| > 32     {(ad > 32).mean():.5f}")
    # PSNR for reference
    mse = (diff ** 2).mean()
    psnr = 10 * np.log10(255.0 ** 2 / mse) if mse > 0 else float("inf")
    print(f"PSNR                 {psnr:.2f} dB")


if __name__ == "__main__":
    main()
