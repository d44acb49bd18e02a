#!/usr/bin/env python3
"""Where the hand kernels of colmap_pcd_tpu_torch spend their time, by
timing variants of their sources on one NVIDIA GPU.

    python3 scripts/torch_kernel_variants.py [--seed 0]

The card offers no profiler in a sealed machine, so this script takes the
place of one: it copies a kernel's source into the build directory with a
part cut out or a tile constant changed, builds it like the real one
(ops/cuda_build.py), binds it to the real wrapper and times the wrapper's
launch alone, as one CUDA graph of 20 launches (device time, no host).

  * K1 on floats (csrc/match_top2.cu) at the matcher's chunks at cap 2048
    and cap 8192 (phase 4's): rows alone and fused with the cross-check, as
    committed; the fused call without the column fold or without the row
    fold (what each epilogue costs); the k loop unrolled 1, 4 and 8 deep;
    and the SM clock and power draw while the fused call runs at cap 8192.
  * K1 on uint8 (csrc/match_top2_u8.cu) at the matcher's two chunks
    (B = 16 at cap 2048 with 1 500-2 048 valid, at cap 4096 with
    1 900-2 200 valid): as committed; without the epilogue's folds; without
    the MMAs; without both (what is left is the TMA stream through L2, the
    barriers and a block's start and end); and with 3 to 12 ring stages.
    A variant's results are wrong by construction; only its time is read.
  * K2 (csrc/nn_argmin.cu) at Q in {37, 128, 256, 512, 1024, 4096} against
    a 504 000-point corridor map: queries per thread, points per selection
    group and threads per block of the many-queries scan; queries per block
    and points per group of the few-queries scan; blocks per SM of the
    split. These variants stay right and are held against the plain version.

With `--float-k1` it times only the float K1's variants and stops. With
`--k2-library Q` it times only K2's library yardstick, blocked
`torch.cdist` + `argmin` (chip_smoke._cdist_argmin), once at Q queries
against the pixel world's 504 000-point map, beside K2 on the same queries
and the bound chip_smoke computes for that shape, and stops: at the fused
cloud's Q = 9 768 196 one call takes tens of seconds, too long for every
smoke run. Its time does not depend on where the queries lie; they are map
points moved by 5 cm, as a fused cloud's are.

Every line carries the card's name and power limit (first line). Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

FOLDS = re.compile(r"(    fold\((lo|hi), fmaf\(\(float\)acc\[4 \* j \+ \d\][^\n]*\n){4}")
ONE_FOLD = ("    if (j == 0) fold(lo, fmaf((float)(acc[0] ^ acc[17] ^ acc[38] ^ acc[63]), "
            "inv_lo * c.x, c.y), col);\n")
MMAS = "for (int k = 0; k < D / 32; ++k) wgmma_m64n128k32_u8("
COL_FOLD = """          if (v > best) {
            best = v;
            bi = i;
          }
"""
ROW_FOLD = "for (int i = 0; i < 8; ++i) fold(top[i], fmaf(acc[i][j], c.x, c.y), col0 + tx + 16 * j);"
ONE_ROW_FOLD = "if (j == 0) fold(top[0], fmaf(acc[0][0], c.x, c.y), col0 + tx);"
UNROLL = "#pragma unroll 2\n    for (int u = 0;"
NO_MMAS = "for (int k = 0; k < 0; ++k) wgmma_m64n128k32_u8("


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--float-k1", action="store_true", help="time only the float K1's variants, then stop")
    ap.add_argument("--k2-library", type=int, metavar="Q", default=None,
                    help="time only K2's library yardstick (and K2) at Q queries, then stop")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_variants: no CUDA device")
    import chip_smoke
    from colmap_pcd_tpu_torch.models.lidar_map import LidarMap
    from colmap_pcd_tpu_torch.ops import cuda_build, match_kernel, nn_kernel
    from synthetic_torch import build_corridor_map

    dev = torch.device("cuda")
    print(f"[env] nvidia-smi: {chip_smoke._nvidia_smi()}", flush=True)
    if args.k2_library:
        return k2_library(args.k2_library, args.seed)
    variants = os.path.join(cuda_build.BUILD_DIR, "variants")
    os.makedirs(variants, exist_ok=True)

    def variant(source: str, name: str, edit) -> str:
        with open(source) as f:
            text = f.read()
        edited = edit(text)
        if edited == text:
            raise RuntimeError(f"variant {name}: the source no longer holds what it edits")
        path = os.path.join(variants, name + ".cu")
        with open(path, "w") as f:
            f.write(edited)
        return path

    def constants(*pairs):
        def edit(text):
            for name, value in pairs:
                text = re.sub(rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};", text)
            return text
        return edit

    # ------------------------------------------------------------ K1, float
    rng = np.random.default_rng(args.seed + 3)
    floats = {}
    for label, shape in (("cap 2048", dict(B=16, N1=2048, N2=2048, n_lo=1500, n_hi=2048)),
                         ("cap 8192", dict(B=16, N1=8192, N2=8192, n_lo=6000, n_hi=8192))):
        floats[label] = tuple(torch.as_tensor(x, device=dev) for x in chip_smoke._k1_case(rng, **shape))
    source_f32 = match_kernel.SOURCE

    def time_f32(label: str, source: str, rows: bool = True):
        lib = match_kernel.load(source)
        ms = []
        for k, (d1, d2, v1, v2) in floats.items():
            if rows:
                ms.append(f"{k} rows {chip_smoke._graph_ms(lambda: match_kernel.launch(lib, d1, d2, v2), 5):.4f}")
            ms.append(f"{k} fused {chip_smoke._graph_ms(lambda: match_kernel.launch(lib, d1, d2, v2, v1), 5):.4f}")
        print(f"[k1-f32] {label}: " + ", ".join(ms) + " ms", flush=True)

    time_f32("as committed", source_f32)
    clocks_under_load(floats["cap 8192"], match_kernel)
    time_f32("no column fold", variant(source_f32, "f32_nocol", lambda t: t.replace(COL_FOLD, "")), rows=False)
    time_f32("no row fold", variant(source_f32, "f32_norow", lambda t: t.replace(ROW_FOLD, ONE_ROW_FOLD)),
             rows=False)
    for depth in (1, 4, 8):
        unrolled = f"#pragma unroll {depth}\n    for (int u = 0;"
        time_f32(f"k loop unrolled {depth} deep",
                 variant(source_f32, f"f32_unroll{depth}", lambda t: t.replace(UNROLL, unrolled)))
    del floats
    if args.float_k1:
        return 0

    # ------------------------------------------------------------------ K1
    rng = np.random.default_rng(args.seed + 2)
    chunks = {}
    for label, shape in (("cap 2048", dict(B=16, N1=2048, N2=2048, n_lo=1500, n_hi=2048)),
                         ("cap 4096", dict(B=16, N1=4096, N2=4096, n_lo=1900, n_hi=2200))):
        case = chip_smoke._k1_case(rng, **shape)
        u1, u2 = (torch.as_tensor(chip_smoke._quantize(x), device=dev) for x in case[:2])
        v1, v2 = (torch.as_tensor(x, device=dev) for x in case[2:])
        chunks[label] = (u1, u2, match_kernel.inverse_norms(u1), match_kernel.inverse_norms(u2), v2, v1)

    source_u8 = match_kernel.SOURCE_U8

    def time_k1(label: str, source: str):
        lib = match_kernel.load_u8(source)
        ms = {k: chip_smoke._graph_ms(lambda: match_kernel.launch_u8(lib, *c), 20) for k, c in chunks.items()}
        print(f"[k1-u8] {label}: " + ", ".join(f"{k} {t:.4f} ms" for k, t in ms.items()), flush=True)

    time_k1("as committed", source_u8)
    time_k1("no epilogue folds", variant(source_u8, "u8_noepi", lambda t: FOLDS.sub(ONE_FOLD, t)))
    time_k1("no MMAs", variant(source_u8, "u8_nomma", lambda t: t.replace(MMAS, NO_MMAS)))
    time_k1("neither (loads, barriers, block start and end)",
            variant(source_u8, "u8_neither", lambda t: FOLDS.sub(ONE_FOLD, t).replace(MMAS, NO_MMAS)))
    for stages in (3, 6, 8, 12):
        time_k1(f"{stages} ring stages", variant(source_u8, f"u8_st{stages}", constants(("STAGES", stages))))

    # ------------------------------------------------------------------ K2
    pts, nrm = build_corridor_map(np.random.default_rng(args.seed), length=105.0)
    lmap = LidarMap.from_arrays(pts, nrm, device="cpu")
    p4 = nn_kernel.pack_points(torch.as_tensor(lmap.points, device=dev))
    queries, ref = {}, {}
    for Q in (37, 128, 256, 512, 1024, 4096):
        q = lmap.points[rng.integers(0, len(pts), Q)] + rng.normal(0, 0.2, (Q, 3))
        queries[Q] = torch.as_tensor(q.astype(np.float32), device=dev)
        ref[Q] = nn_kernel.nn_argmin_reference(queries[Q], p4)[1]
    source_nn = nn_kernel.SOURCE
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def time_k2(label, source, per_sm, few_max):
        lib = nn_kernel.load(source)  # its tile sizes come with it (lib.tiles)
        out = []
        for Q, q in queries.items():
            plan = nn_kernel.launch_plan(Q, p4.shape[0], sms, lib.tiles, few_max=few_max,
                                         blocks_per_sm=per_sm)
            dist = nn_kernel.launch(lib, q, p4, plan)[1]
            torch.cuda.synchronize()
            if not torch.allclose(dist, ref[Q], rtol=1e-5, atol=1e-6):
                raise AssertionError(f"K2 variant {label} disagrees with the plain version at Q={Q}")
            out.append(f"Q={Q} {chip_smoke._graph_ms(lambda: nn_kernel.launch(lib, q, p4, plan), 20):.4f}")
        print(f"[k2] {label}, {per_sm} blocks/SM: " + ", ".join(out) + " ms", flush=True)

    for qpt, g, threads in ((4, 16, 128), (8, 8, 128), (8, 16, 256), (4, 8, 128), (4, 32, 128),
                            (4, 16, 256), (2, 32, 256)):
        src = variant(source_nn, f"nn_q{qpt}_g{g}_t{threads}",
                      constants(("QT_QPT", qpt), ("QT_G", g), ("QT_THREADS", threads))) \
            if (qpt, g, threads) != (4, 16, 128) else source_nn
        for per_sm in (2, 4):
            time_k2(f"queries in registers: {qpt} a thread, groups of {g}, {threads} threads",
                    src, per_sm, 0)
    for pq, pg in ((8, 4), (16, 4), (8, 8), (4, 8)):
        src = variant(source_nn, f"nn_pq{pq}_pg{pg}", constants(("PT_QPT", pq), ("PT_G", pg))) \
            if (pq, pg) != (8, 4) else source_nn
        for per_sm in (1, 2, 4):
            time_k2(f"points split among threads: {pq} queries a block, groups of {pg}",
                    src, per_sm, 1 << 30)
    return 0


def clocks_under_load(case, match_kernel, seconds: float = 3.0):
    """The SM clock and power draw (nvidia-smi, every 100 ms) while the
    float K1's fused call runs back to back for `seconds`, and the card's
    f32 FMA peak at that clock (132 SMs x 128 lanes x 2 flops)."""
    import subprocess
    import time

    import torch

    d1, d2, v1, v2 = case
    lib = match_kernel.build()
    match_kernel.launch(lib, d1, d2, v2, v1)
    torch.cuda.synchronize()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
                            "-lms", "100"], stdout=subprocess.PIPE, text=True)
    try:
        t0, calls = time.perf_counter(), 0
        while time.perf_counter() - t0 < seconds:
            match_kernel.launch(lib, d1, d2, v2, v1)
            calls += 1
            if calls % 8 == 0:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=30)[0]
    rows = [tuple(float(x) for x in line.split(",")) for line in out.strip().splitlines()[2:-1]]
    mhz = sorted(r[0] for r in rows)
    watts = sorted(r[1] for r in rows)
    med = mhz[len(mhz) // 2]
    print(f"[k1-f32] under the fused call at cap 8192 ({calls} calls, {len(rows)} samples): SM clock "
          f"{mhz[0]:.0f}-{mhz[-1]:.0f} MHz (median {med:.0f}), power {watts[0]:.1f}-{watts[-1]:.1f} W "
          f"(median {watts[len(watts) // 2]:.1f}); f32 FMA peak at the median clock "
          f"{132 * 128 * 2 * med * 1e6 / 1e12:.1f} TFLOP/s", flush=True)


def k2_library(Q: int, seed: int) -> int:
    """Blocked torch.cdist + argmin once at Q queries against the pixel
    world's map (CUDA events, after a warm-up on one block), K2 on the same
    queries, their agreement, and the bound of that shape."""
    import time

    import torch

    import chip_smoke
    from colmap_pcd_tpu_torch.models.lidar_map import LidarMap
    from colmap_pcd_tpu_torch.ops import nn_kernel
    from synthetic_torch import build_corridor_map

    dev = torch.device("cuda")
    pts, nrm = build_corridor_map(np.random.default_rng(0), length=100 * chip_smoke.PIXEL_STEP + 25)
    lmap = LidarMap.from_arrays(pts, nrm, device="cpu")
    rng = np.random.default_rng(seed)
    q = (lmap.points[rng.integers(0, len(lmap.points), Q)] + rng.normal(0, 0.05, (Q, 3))).astype(np.float32)
    q_d = torch.as_tensor(q, device=dev)
    p_d = torch.as_tensor(lmap.points, device=dev)
    p4 = nn_kernel.pack_points(p_d)
    N = p_d.shape[0]

    def timed(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    chip_smoke._cdist_argmin(q_d[:1024], p_d)
    nn_kernel.nn_argmin(q_d[:1024], p4)
    t0 = time.perf_counter()
    lib_idx, lib_ms = timed(lambda: chip_smoke._cdist_argmin(q_d, p_d))
    wall_s = time.perf_counter() - t0
    (k2_idx, k2_dist), k2_ms = timed(lambda: nn_kernel.nn_argmin(q_d, p4))
    d_lib = torch.linalg.norm(p_d[lib_idx] - q_d, dim=1)
    worst = float(torch.max(torch.abs(d_lib - k2_dist) / torch.clamp(k2_dist, min=1e-6)))
    differ = int((lib_idx != k2_idx.long()).sum())
    bound_ms, bound_by = chip_smoke._bound(12 * Q + 12 * N + 8 * Q, 8.0 * Q * N, chip_smoke.F32_FLOPS)
    print(f"[k2 library] Q={Q} N={N}: cdist+argmin (blocks of 1024) {lib_ms:.4f} ms (CUDA events, one call; "
          f"{wall_s:.3f} s host clock); K2 {k2_ms:.4f} ms (one call); bound {bound_ms:.4f} ms ({bound_by}); "
          f"indices differing {differ}, the library's distances within {worst:.3g} relative of K2's "
          "(cdist forms |q|^2 + |p|^2 - 2 q.p, which loses millimetres at map scale)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
