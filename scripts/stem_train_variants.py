#!/usr/bin/env python3
"""Time variants of the train stem's conv + statistics kernel (K3) side by
side on one card.

    python3 scripts/stem_train_variants.py          # from the repository root

As ``scripts/stem_serve_variants.py`` does for K1, with its helpers: each
variant is ``csrc/stem_train.cu`` and ``csrc/stem_common.cuh`` with one
textual change, built with the port's nvcc flags (one nvcc each, started
together) into ``singleshotpose_tpu_torch/_build/train_variants/``.  On the
batch-8 train step's shapes (416², then the 320² and 832² buckets of the
multi-scale schedule) it prints each variant's registers and spill
stores (``-Xptxas -v``, for each of K3's two instances), its share of y
equal to the plain version's and its sums' error (for the variants that
compute the kernel's function), and its time:
CUDA events around 50 back-to-back calls of the C entry point (K3 and its
partial-sum pass), per call, in three rounds of turns.  The kernel copies
each group's 2 KB of y from shared memory with one bulk copy under an L2
evict-first policy; the store variants are the bulk copy without the
policy (``bulk_no_hint``) and y's 16-byte stores by every lane through a
swizzled buffer, with a streaming hint (``stcs``) and without
(``st_plain``).  ``rows4`` takes 4-row tiles.  The variants that drop part of the work (``copies_stores``,
``no_copies``, ``no_stores``) say what the rest costs, and a
device-to-device copy of the kernel's bytes (``copy_``) gives the memory
rate this card reaches on plain streaming.  Needs one CUDA card and nvcc;
imports no jax.
"""

from __future__ import annotations

import ctypes
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from singleshotpose_tpu_torch.ops import cuda_build, stem  # noqa: E402
from stem_serve_variants import (_chain, _sub, build_variants,  # noqa: E402
                                 card, ptxas_usage, time_in_turns)

SHAPES = ((8, 416, 416), (8, 320, 320), (8, 832, 832))

def _lane_stores(store: str):
    """y leaves as 16-byte stores by every lane (``store`` the statement,
    given ``out``, ``pix``, ``c`` and the chunk ``v``), 512 contiguous bytes
    a warp store, through a buffer whose chunks are XOR-swizzled by g & 3 so
    that its 4-byte writes meet no bank conflict."""
    return _chain(
        _sub("const int dx0 = g >= 4;", "const int dx0 = g >= 4, sw = g & 3;"),
        _sub("const int c = 32 * dy + 4 * n;",
             "const int c = 32 * dy + 4 * (n ^ sw);"),
        _sub("      if (lane == 0) bulk_wait_read();\n      __syncwarp();\n", ""),
        _sub("""      // every lane's writes reach the async proxy; then one lane copies the
      // group's pixels up to the last pooled column
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        const int npix = Wp - px < 8 ? Wp - px : 8;
        bulk_store_evict_first(
            y + (((long long)tile.b * Hp + py) * Wp + px) * 2 * kPixWords,
            regroup[warp], npix * 4 * kPixWords);
      }
""", """      __syncwarp();
      uint4* out = reinterpret_cast<uint4*>(y) +
                   (((long long)tile.b * Hp + py) * Wp + px) * (kPixWords / 4);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int pix = 2 * k + lane / 16, c = lane % 16;
        const uint4 v = *reinterpret_cast<const uint4*>(
            regroup[warp] + pix * kPixWords + 4 * (c ^ (pix & 3)));
        if (px + pix < Wp) """ + store + """;
      }
      __syncwarp();
"""))


# name: (change, computes the kernel's function)
VARIANTS = {
    "kernel": (None, True),
    "bulk_no_hint": (_chain(
        _sub('bulk_group.L2::cache_hint"', 'bulk_group"'),
        _sub('" [%0], [%1], %2, %3;', '" [%0], [%1], %2;')), True),
    "stcs": (_lane_stores("__stcs(out + pix * (kPixWords / 4) + c, v)"), True),
    "st_plain": (_lane_stores("out[pix * (kPixWords / 4) + c] = v"), True),
    "rows4": (_sub("constexpr int kConvRows = 8; ",
                   "constexpr int kConvRows = 4; "), True),
    # what parts cost: W < 0 never holds, so the compiler keeps the rest
    "copies_stores": (_sub("      for (int dy = 0; dy < 2; ++dy) {\n"
                           "        float acc[4][4];",
                           "      for (int dy = 0; dy < 0; ++dy) {\n"
                           "        float acc[4][4];"), False),
    "no_copies": (_sub("    if (i + (kConvStages - 1) * grid < ntiles)",
                       "    if (W < 0)"), False),
    "no_stores": (_sub("      if (lane == 0) {\n        const int npix",
                       "      if (lane == 0 && W < 0) {\n        const int npix"),
                  False),
}


def _run_shape(built: dict, dev, B: int, H: int, W: int, smi: str) -> None:
    g = torch.Generator(device=dev).manual_seed(H)
    img = torch.rand((B, H, W, 3), generator=g, device=dev)
    w = torch.randn((32, 3, 3, 3), generator=g, device=dev) * 0.3
    y_ref, sums_ref = stem.stem_conv_stats_reference(img, w)
    y = torch.empty_like(y_ref)
    sums = torch.empty_like(sums_ref)
    stream = torch.cuda.current_stream().cuda_stream
    i = ctypes.c_int

    def launcher(lib):
        blocks = lib.stem_conv_stats_blocks
        blocks.restype = ctypes.c_longlong
        blocks.argtypes = [i, i, i]
        partials = torch.empty((blocks(B, H, W), 2, 32), device=dev)

        def launch():
            err = lib.stem_conv_stats_launch(
                img.data_ptr(), w.data_ptr(), y.data_ptr(),
                partials.data_ptr(), sums.data_ptr(), B, H, W, stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
        return launch

    label = f"({B},{H},{W}) "
    runs = {name: launcher(lib) for name, (lib, _) in built.items()}
    nbytes = img.numel() * 4 + y_ref.numel() * 2
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    runs["copy_"] = lambda: dst.copy_(src)
    for name, (_, log) in built.items():
        y.zero_()
        runs[name]()
        torch.cuda.synchronize()
        if VARIANTS[name][1]:
            exact = float((y == y_ref).float().mean())
            rel = float((sums - sums_ref).abs().max() / sums_ref.abs().max())
            what = (f"y {exact:.6%} equal to the plain version's, sums rel "
                    f"{rel:.3g}")
        else:
            what = "drops work: not compared"
        print(f"[variants] {label}{name}: "
              f"{ptxas_usage(log, 'stem_conv_stats_kernel')}; {what}")
    time_in_turns(runs, nbytes, smi, label)


def main() -> int:
    smi = card()
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    p, i = ctypes.c_void_p, ctypes.c_int
    built = build_variants(
        os.path.join(cuda_build.BUILD_DIR, "train_variants"), "stem_train",
        VARIANTS, "stem_conv_stats_launch", [p] * 5 + [i] * 3 + [p])
    for B, H, W in SHAPES:
        _run_shape(built, dev, B, H, W, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
