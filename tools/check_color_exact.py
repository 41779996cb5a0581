"""Exhaustive validation: device (pure-float32) color conversion == oracle.

The reference computes each channel with double-precision products rounded
once to float32 (cpp color.cpp:8-19).  The device path computes in f32
only.  IDCT output is clipped to [-256, 255]
(parser.cu:211-215), so the color-conversion input domain is finite:
512^3 = 134M (Y, Cb, Cr) triples.  This script checks every one of them:
if the final clamped integer RGB matches the oracle everywhere, the f32
device formula is *proven* bit-exact for all reachable inputs.

Result is recorded in tpujpeg/ops/color.py's docstring.
"""

import numpy as np

from tpujpeg.constants import C_BLUE, C_GY_B, C_GY_DIV, C_GY_R, C_RED


def oracle_rgb(y, cb, cr):
    yf = y.astype(np.float64)
    r32 = (C_RED * cr + yf).astype(np.float32)
    b32 = (C_BLUE * cb + yf).astype(np.float32)
    g32 = (
        (yf - C_GY_B * b32.astype(np.float64) - C_GY_R * r32.astype(np.float64))
        / C_GY_DIV
    ).astype(np.float32)
    out = []
    for ch in (r32, g32, b32):
        out.append(np.clip(np.trunc(ch + np.float32(128.0)).astype(np.int32), 0, 255))
    return out


def device_rgb(y, cb, cr):
    """Candidate f32-only formula (what the device computes)."""
    yf = y.astype(np.float32)
    cbf = cb.astype(np.float32)
    crf = cr.astype(np.float32)
    r32 = np.float32(C_RED) * crf + yf
    b32 = np.float32(C_BLUE) * cbf + yf
    # green: oracle computes (y - 0.114*b - 0.299*r)/0.587 in f64 with the
    # f32-rounded b,r, then rounds once to f32.  Candidate: same shape in f32.
    g32 = (yf - np.float32(C_GY_B) * b32 - np.float32(C_GY_R) * r32) * np.float32(
        1.0 / C_GY_DIV
    )
    g32_div = (yf - np.float32(C_GY_B) * b32 - np.float32(C_GY_R) * r32) / np.float32(
        C_GY_DIV
    )
    out = []
    for ch in (r32, g32, b32):
        out.append(np.clip(np.trunc(ch + np.float32(128.0)).astype(np.int32), 0, 255))
    g_div = np.clip(np.trunc(g32_div + np.float32(128.0)).astype(np.int32), 0, 255)
    return out, g_div


def main():
    vals = np.arange(-256, 256, dtype=np.int32)
    # R depends on (Y, Cr); B on (Y, Cb): 262k combos each — check first.
    y2, c2 = np.meshgrid(vals, vals, indexing="ij")
    (oR, _, oB) = oracle_rgb(y2, c2, c2)
    (dR, _, dB), _ = device_rgb(y2, c2, c2)
    print("R exact:", np.array_equal(oR, dR), "| B exact:", np.array_equal(oB, dB))

    # G depends on all three: sweep Y in chunks.
    bad_mul = 0
    bad_div = 0
    cb3, cr3 = np.meshgrid(vals, vals, indexing="ij")
    for yv in vals:
        y3 = np.full_like(cb3, yv)
        _, oG, _ = oracle_rgb(y3, cb3, cr3)
        (_, dG, _), dG_div = device_rgb(y3, cb3, cr3)
        bad_mul += int((oG != dG).sum())
        bad_div += int((oG != dG_div).sum())
        if yv % 64 == 0:
            print(f"y={yv}: mul-mismatch={bad_mul} div-mismatch={bad_div}")
    total = 512**3
    print(f"G: {bad_mul}/{total} mismatch (reciprocal-mul), {bad_div}/{total} (divide)")


if __name__ == "__main__":
    main()
