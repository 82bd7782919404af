#!/usr/bin/env python3
"""Time variants and tiles of the int8 conv kernel on one card.

    python3 scripts/int8_conv_variants.py            # from the repository root
    python3 scripts/int8_conv_variants.py --tiles    # also every tile a shape
    python3 scripts/int8_conv_variants.py --extra --layers conv_1:8,conv_19:1

Each variant is ``csrc/int8_conv.cu`` with one textual change, built with
the port's nvcc flags (one nvcc each, started together) into
``singleshotpose_tpu_torch/_build/variants/``.  At a few layers of the
int8 serves (conv_1, conv_2, conv_3 at batch 8, 672²; conv_19 at batch 8
and 1) it prints each variant's device ms a call, in the layer's epilogue
mode (``fused``: what the serve's plan writes, with per-channel scales in
the multiply form) and without the epilogue (``int32``): CUDA graphs of 10
calls, the median of 5 replays, in turns (forward, then backward through
the list).  The variants that drop part of the work (``no_epilogue``,
``no_gather``, ``no_tma``, ``no_mma``) say what the rest costs; ``base``
and ``no_fence`` (without the consumers' proxy fence) are checked bit for
bit against the plain twin.  ``--extra`` adds the pipeline's skeleton (no
gather, no epilogue), its handshakes alone (no TMA, no wgmma either), a
busy-polling wait, a ring capped at 4 stages and stages of one 128-byte K
block (``kb1``, against two); ``--layers`` picks the
layers (``name:batch``).

With ``--tiles``: for every distinct int8 conv shape of the batch-8 and
batch-1 672² serves and the batch-16 416² multi serve, in its fused mode,
the time of each tile (BM, BN) the kernel has, and the tile
``ops.int8_conv.tile_for`` picks — the measurement behind that table.
Needs one CUDA card and nvcc; imports no jax.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
from unittest import mock

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))
from singleshotpose_tpu_torch.models import quantize as Q  # noqa: E402
from singleshotpose_tpu_torch.ops import cuda_build  # noqa: E402
from singleshotpose_tpu_torch.ops import int8_conv as I  # noqa: E402
from singleshotpose_tpu_torch.zoo import (yolo_pose_multi,  # noqa: E402
                                          yolo_pose_single)
from stem_serve_variants import (_chain, _sub, build_variants,  # noqa: E402
                                 card, ptxas_usage)

VARIANTS = {
    "base": (None, True),
    "no_fence": (_sub("      fence_async_shared();               // the "
                      "gathered A, for wgmma\n", ""), True),
    "no_epilogue": (_sub("    const int m_wg = m0 + wg * 64;\n",
                         "    const int m_wg = m0 + wg * 64;\n"
                         "    if (s.B > 0) continue;\n"), False),
    "no_gather": (_chain(
        _sub("        if constexpr (kVec == 16) {",
             "        if (kVec == 16 && s.B < 0) {"),
        _sub("        } else if (iy0[0] != kNoRow) {",
             "        } else if (iy0[0] != kNoRow && s.B < 0) {")), False),
    "no_tma": (_sub("          mbar_expect_tx(&full[st], blocks * kBBlock);\n"
                    "          for (int cb = 0; cb < blocks; ++cb)\n"
                    "            tma_load_2d(b_ring + st * kBStage + cb * "
                    "kBBlock, &wmap,\n"
                    "                        k0 + cb * kRowBytes, n0, "
                    "&full[st]);",
                    "          mbar_arrive(&full[st]);"), False),
    "no_mma": (_sub("        if (kk < nk)\n          wgmma_k32",
                    "        if (kk < nk && s.B < 0)\n          wgmma_k32"),
               False),
}
# what the pipeline's skeleton costs alone, and two changes to it
_NO_GATHER, _NO_EPILOGUE = VARIANTS["no_gather"][0], VARIANTS["no_epilogue"][0]
EXTRA = {
    "skeleton": (_chain(_NO_GATHER, _NO_EPILOGUE), False),
    "handshakes": (_chain(_NO_GATHER, _NO_EPILOGUE, VARIANTS["no_tma"][0],
                          VARIANTS["no_mma"][0]), False),
    "test_wait": (_sub("mbarrier.try_wait.parity.shared::cta.b64",
                       "mbarrier.test_wait.parity.shared::cta.b64"), True),
    "stages4": (_sub("constexpr int kMaxStages = 8;",
                     "constexpr int kMaxStages = 4;"), True),
    "kb1": (_sub("constexpr int kStageBlocks = kBN == 32 ? 1 : 2;",
                 "constexpr int kStageBlocks = 1;"), True),
}
# (layer, batch): layers of the 672² serve
LAYERS = (("conv_1", 8), ("conv_2", 8), ("conv_3", 8), ("conv_19", 8),
          ("conv_19", 1))
CALLS, REPS, ROUNDS = 10, 5, 2
TILES = tuple((bm, bn) for bm in (64, 128) for bn in (32, 64, 128))


def graph_ms(fn) -> float:
    """Device ms a call: CALLS calls in one CUDA graph, the median of REPS
    replays timed with CUDA events."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / CALLS)
    return statistics.median(times)


def serve_layers(spec, size: int):
    """(conv spec, input height, plan) of each conv the serve quantizes by
    default, its input square at ``size``."""
    from singleshotpose_tpu_torch.models import darknet as D
    skip = Q.default_skip_layers(spec)
    quantized = {l.name for l in spec.layers
                 if isinstance(l, D.ConvSpec) and l.name not in skip}
    plan = Q.epilogue_plan(spec, quantized)
    heights, h, out = [], size, []
    for lspec in spec.layers:
        if isinstance(lspec, D.ConvSpec):
            if lspec.name in quantized:
                out.append((lspec, h, plan[lspec.name]))
            h = (h + 2 * lspec.pad - lspec.size) // lspec.stride + 1
        elif isinstance(lspec, D.MaxPoolSpec) and lspec.stride > 1:
            h = (h - lspec.size) // lspec.stride + 1
        elif isinstance(lspec, D.ReorgSpec):
            h //= lspec.stride
        elif isinstance(lspec, D.RouteSpec):
            h = heights[lspec.layers[0]]
        heights.append(h)
    return out


def layer_case(dev, g, B, h, lspec, plan):
    """Random int8 input and weights of a layer (C_in padded to 4) and the
    serve's epilogue for it: per-channel scales, the multiply form."""
    C = -(-lspec.in_filters // 4) * 4
    N, k = lspec.filters, lspec.size
    x = torch.randint(-127, 128, (B, h, h, C), generator=g, device=dev,
                      dtype=torch.int32).to(torch.int8)
    wq = torch.randint(-127, 128, (k, k, C, N), generator=g, device=dev,
                       dtype=torch.int32).to(torch.int8)
    wk = I.pack_weights(wq)
    sd = float(I.int8_conv_reference(x[:1], wk, k, lspec.stride,
                                     lspec.pad).float().std()) + 1.0
    ep = I.Epilogue(
        torch.rand(N, generator=g, device=dev) * 2 / sd,
        torch.randn(N, generator=g, device=dev),
        quant=(torch.rand(N, generator=g, device=dev) * 20 + 10)
        if plan.consumer else None, value=plan.value)
    return x, wk, ep


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiles", action="store_true",
                    help="also time every tile at every serve shape")
    ap.add_argument("--extra", action="store_true",
                    help="add the skeleton variants (EXTRA)")
    ap.add_argument("--layers", default=",".join(f"{n}:{b}" for n, b in LAYERS),
                    help="layer:batch,... to time (default: %(default)s)")
    args = ap.parse_args()
    variants = {**VARIANTS, **(EXTRA if args.extra else {})}
    layer_list = [(n, int(b)) for n, b in
                  (x.split(":") for x in args.layers.split(","))]
    smi = card()
    dev = torch.device("cuda", 0)
    built = build_variants(
        os.path.join(cuda_build.BUILD_DIR, "variants"), "int8_conv",
        variants, "int8_conv_launch", I._library().int8_conv_launch.argtypes)
    for name, (_, log) in built.items():
        print(f"[variants] {name}: {ptxas_usage(log, 'int8_conv_kernel')}")
    g = torch.Generator(device=dev).manual_seed(0)
    spec = yolo_pose_single()
    layers = serve_layers(spec, 672)
    for label, B in layer_list:
        lspec, h, plan = next(x for x in layers if x[0].name == label)
        x, wk, ep = layer_case(dev, g, B, h, lspec, plan)
        args_ = (x, wk, lspec.size, lspec.stride, lspec.pad)
        K = lspec.size ** 2 * x.shape[-1]
        for mode, epi in (("fused", ep), ("int32", None)):
            want = I.int8_conv_reference(*args_, epilogue=epi)
            runs = {}
            for name, (lib, _) in built.items():
                runs[name] = (lambda lib=lib, epi=epi: I.int8_conv(
                    *args_, epilogue=epi)), lib
                if variants[name][1]:
                    with mock.patch.object(I, "_library", lambda lib=lib: lib):
                        try:
                            got = I.int8_conv(*args_, epilogue=epi)
                        except RuntimeError as err:   # too much shared memory
                            print(f"[variants] {name} at {label}: {err}")
                            continue
                    torch.cuda.synchronize()
                    pairs = [(got, want)] if epi is None else zip(got, want)
                    same = all((a is None) == (b is None) and (
                        a is None or torch.equal(a.view(torch.uint8) if
                                                 a.dtype == torch.int8 else a,
                                                 b.view(torch.uint8) if
                                                 b.dtype == torch.int8 else b))
                        for a, b in pairs)
                    if not same:
                        raise SystemExit(f"variant {name} != twin at {label}")
            times = {name: [] for name in runs}
            order = list(runs) + list(reversed(list(runs)))
            for _ in range(ROUNDS):
                for name in order:
                    fn, lib = runs[name]
                    with mock.patch.object(I, "_library", lambda lib=lib: lib):
                        try:
                            times[name].append(graph_ms(fn))
                        except RuntimeError:
                            times[name].append(float("nan"))
            print(f"[variants] {label} ({B},{h},{h},{x.shape[-1]})->"
                  f"{lspec.filters} {lspec.size}x{lspec.size} {mode} "
                  f"({plan.writes if epi is not None else 'int32'}), tile "
                  f"{I.tile_for(B * h * h, lspec.filters, K)}: " + ", ".join(
                      f"{n} {statistics.median(t):.4f}" for n, t in
                      times.items()) + f" ms [{smi}]")
    if args.tiles:
        shapes = {}
        for net, B, size in ((spec, 8, 672), (spec, 1, 672),
                             (yolo_pose_multi(), 16, 416)):
            for lspec, h, plan in serve_layers(net, size):
                key = (B, h, lspec.in_filters, lspec.filters, lspec.size,
                       lspec.stride, lspec.pad, plan.writes)
                shapes.setdefault(key, (lspec, plan))
        for key, (lspec, plan) in shapes.items():
            B, h = key[:2]
            x, wk, ep = layer_case(dev, g, B, h, lspec, plan)
            res = {}
            for tile in TILES:
                res[tile] = graph_ms(lambda: I.int8_conv(
                    x, wk, lspec.size, lspec.stride, lspec.pad, epilogue=ep,
                    tile=tile))
            best = min(res, key=res.get)
            pick = I.tile_for(B * h * h, lspec.filters,
                              lspec.size ** 2 * x.shape[-1])
            print(f"[tiles] ({B},{h},{h},{x.shape[-1]})->{lspec.filters} "
                  f"{lspec.size}x{lspec.size} {plan.writes}: " + ", ".join(
                      f"{t[0]}x{t[1]} {ms:.4f}" for t, ms in res.items())
                  + f" ms; best {best[0]}x{best[1]}, tile_for {pick[0]}x"
                  f"{pick[1]} ({res[pick] / res[best]:.3f}x the best) "
                  f"[{smi}]")
            del x, wk, ep
    return 0


if __name__ == "__main__":
    sys.exit(main())
