#!/usr/bin/env python3
"""Time variants of the serving-stem kernel (K1) side by side on one card.

    python3 scripts/stem_serve_variants.py           # from the repository root

Each variant is ``csrc/stem_serve.cu`` and ``csrc/stem_common.cuh`` with one
textual change, built with the port's nvcc flags (one nvcc each, started
together) into ``singleshotpose_tpu_torch/_build/variants/``.  On the
batch-8 672² serving shape it prints each variant's registers and spill
stores (``-Xptxas -v``), its share of outputs equal to the plain version's
(for the variants that compute the same function), and its time: CUDA
events around 50 back-to-back launches, per launch, in three rounds of
turns (forward, then backward through the list).  The variants that drop
part of the work (``copies_stores``, ``no_copies``, ``no_stores``) say what
the rest costs.  Last, a device-to-device copy of the same byte count
(``copy_``) gives the memory rate this card reaches on plain streaming.
Needs one CUDA card and nvcc; imports no jax.  ``scripts/
stem_train_variants.py`` does the same for K3 with this script's helpers.
"""

from __future__ import annotations

import ctypes
import os
import re
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from singleshotpose_tpu_torch.ops import cuda_build, stem  # noqa: E402

SHAPE = (8, 672, 672)
LAUNCHES, ROUNDS = 50, 3


def _sub(old: str, new: str, where: str = "main"):
    """A change: replace ``old`` (which must occur once) in one source,
    ``"main"`` (the kernel's ``.cu``) or ``"common"`` (``stem_common.cuh``)."""
    def change(srcs):
        assert srcs[where].count(old) == 1, old
        return {**srcs, where: srcs[where].replace(old, new)}
    return change


def _chain(*changes):
    def change(srcs):
        for c in changes:
            srcs = c(srcs)
        return srcs
    return change


# the second k-step accumulated on the first's sum on the tensor cores
_CHAIN_C = _chain(
    _sub("// acc[n][e]: the f32 conv outputs",
         "__device__ __forceinline__ void mma_bf16_acc(\n"
         "    float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1,\n"
         "    const float (&c)[4]) {\n"
         "  asm volatile(\n"
         "      \"mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 \"\n"
         "      \"{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
         "{%10, %11, %12, %13};\\n\"\n"
         "      : \"=f\"(d[0]), \"=f\"(d[1]), \"=f\"(d[2]), \"=f\"(d[3])\n"
         "      : \"r\"(a[0]), \"r\"(a[1]), \"r\"(a[2]), \"r\"(a[3]), "
         "\"r\"(b0), \"r\"(b1),\n"
         "        \"f\"(c[0]), \"f\"(c[1]), \"f\"(c[2]), \"f\"(c[3]));\n"
         "}\n\n// acc[n][e]: the f32 conv outputs", "common"),
    _sub("    float d0[4], d1[4];\n"
         "    mma_bf16(d0, a[0], b[0][n][0], b[0][n][1]);\n"
         "    mma_bf16(d1, a[1], b[1][n][0], b[1][n][1]);\n"
         "#pragma unroll\n"
         "    for (int e = 0; e < 4; ++e) acc[n][e] = __fadd_rn(d0[e], d1[e]);",
         "    float d0[4];\n"
         "    mma_bf16(d0, a[0], b[0][n][0], b[0][n][1]);\n"
         "    mma_bf16_acc(acc[n], a[1], b[1][n][0], b[1][n][1], d0);",
         "common"))
_LEAKY_EACH = _chain(
    _sub("          const uint32_t m = bf16x2_max(\n"
         "              biased(acc[n][0], acc[n][1], bs[n][0], bs[n][1]),\n"
         "              biased(acc[n][2], acc[n][3], bs[n][0], bs[n][1]));",
         "          const uint32_t m = bf16x2_max(\n"
         "              leaky(biased(acc[n][0], acc[n][1], bs[n][0], bs[n][1])),\n"
         "              leaky(biased(acc[n][2], acc[n][3], bs[n][0], bs[n][1])));"),
    _sub("      for (int n = 0; n < 4; ++n) best[n] = leaky(best[n]);",
         "      for (int n = 0; n < 4; ++n) best[n] = best[n];"))
_NO_COMPUTE = _sub(
    "      uint32_t best[4];\n#pragma unroll\n"
    "      for (int dy = 0; dy < 2; ++dy) {",
    "      uint32_t best[4];\n"
    "      for (int n = 0; n < 4; ++n) best[n] = __float_as_uint(group[n * kS]);\n"
    "#pragma unroll\n      for (int dy = 0; dy < 0; ++dy) {")

# name: (change, computes the kernel's function)
VARIANTS = {
    "kernel": (None, True),
    "chain_c": (_CHAIN_C, True),
    "leaky_each": (_LEAKY_EACH, True),
    "groups_rolled": (_sub("#pragma unroll\n    for (int q = 0;",
                           "#pragma unroll 1\n    for (int q = 0;"), True),
    "blocks3": (_sub("constexpr int kBlocksPerSm = 2;",
                     "constexpr int kBlocksPerSm = 3;"), True),
    "rows16": (_sub("constexpr int kTileRows = 8; ",
                    "constexpr int kTileRows = 16; "), True),
    "stages4": (_sub("constexpr int kStages = 3;",
                     "constexpr int kStages = 4;"), True),
    # what parts cost: W < 0 never holds, so the compiler keeps the rest
    "copies_stores": (_NO_COMPUTE, False),
    "no_copies": (_sub("    if (i + (kStages - 1) * grid < ntiles)",
                       "    if (W < 0)"), False),
    "no_stores": (_sub("      if (px < Wp)\n", "      if (px < Wp && W < 0)\n"),
                  False),
}


def build_variants(out_dir: str, source: str, variants: dict, entry: str,
                   argtypes: list):
    """Writes ``csrc/<source>.cu`` and ``csrc/stem_common.cuh`` with each
    variant's change (``variants``: {name: (change or None, ...)}) into
    ``out_dir/<name>/`` and builds them, one nvcc each, started together;
    returns {name: (library, ptxas log)} with ``entry`` bound to
    ``argtypes`` (returning an int)."""
    with open(os.path.join(cuda_build.CSRC_DIR, f"{source}.cu")) as f:
        main = f.read()
    with open(os.path.join(cuda_build.CSRC_DIR, "stem_common.cuh")) as f:
        common = f.read()
    nvcc = cuda_build._nvcc()
    procs = {}
    for name, (change, *_) in variants.items():
        srcs = {"main": main, "common": common}
        if change is not None:
            srcs = change(srcs)
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{source}.cu"), "w") as f:
            f.write(srcs["main"])
        with open(os.path.join(d, "stem_common.cuh"), "w") as f:
            f.write(srcs["common"])
        procs[name] = subprocess.Popen(
            [nvcc, *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(d, "lib.so"), os.path.join(d, f"{source}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, name, "lib.so"))
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        built[name] = (lib, log)
    return built


def ptxas_usage(log: str, kernel: str) -> str:
    """Registers and spill stores of each compiled instance of ``kernel``
    in a ``-Xptxas -v`` log, in the log's order, as "registers a/b, spill
    stores c/d"."""
    regs, spills = [], []
    for entry in log.split("Compiling entry function '")[1:]:
        if kernel in entry.split("'", 1)[0]:
            regs += re.findall(r"Used (\d+) registers", entry)[:1]
            spills += re.findall(r"(\d+) bytes spill stores", entry)[:1]
    return f"registers {'/'.join(regs)}, spill stores {'/'.join(spills)}"


def per_launch_us(fn) -> float:
    """CUDA events around LAUNCHES back-to-back calls of ``fn``, per call."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(LAUNCHES):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / LAUNCHES * 1e3


def card() -> str:
    """The card's name and power limit; fails without a card."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{os.path.basename(sys.argv[0])}: needs a CUDA card")
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_in_turns(runs: dict, nbytes: int, smi: str, label: str = "") -> None:
    """Times each of ``runs`` ({name: fn}, ``copy_`` among them) with
    :func:`per_launch_us` in ROUNDS rounds of turns, forward then backward
    through the list, and prints the median and range of each after
    ``label``; ``copy_`` also as the rate of its ``nbytes``."""
    times = {name: [] for name in runs}
    order = list(runs) + list(reversed(list(runs)))
    for _ in range(ROUNDS):
        for name in order:
            times[name].append(per_launch_us(runs[name]))
    for name, ts in times.items():
        extra = f" ({nbytes / statistics.median(ts) / 1e6:.3f} TB/s)" \
            if name == "copy_" else ""
        print(f"[variants] {label}{name}: {statistics.median(ts):.2f} µs a launch "
              f"(median of {len(ts)}; {min(ts):.2f}-{max(ts):.2f}){extra} "
              f"[{smi}]")


def main() -> int:
    smi = card()
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    built = build_variants(
        os.path.join(cuda_build.BUILD_DIR, "variants"), "stem_serve",
        VARIANTS, "stem_conv_pool_infer_launch",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    g = torch.Generator(device=dev).manual_seed(0)
    B, H, W = SHAPE
    img = torch.rand((B, H, W, 3), generator=g, device=dev)
    w = torch.randn((32, 3, 3, 3), generator=g, device=dev) * 0.2
    b = torch.randn((32,), generator=g, device=dev) * 0.2
    ref = stem.stem_conv_pool_infer_reference(img, w, b)
    out = torch.empty_like(ref)
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(fn):
        def launch():
            err = fn(img.data_ptr(), w.data_ptr(), b.data_ptr(),
                     out.data_ptr(), B, H, W, stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
        return launch

    runs = {name: launcher(lib.stem_conv_pool_infer_launch)
            for name, (lib, _) in built.items()}
    nbytes = img.numel() * 4 + ref.numel() * 2
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    runs["copy_"] = lambda: dst.copy_(src)
    for name, (_, log) in built.items():
        out.zero_()
        runs[name]()
        torch.cuda.synchronize()
        exact = float((out.float() == ref.float()).float().mean())
        what = f"{exact:.6%} equal to the plain version" \
            if VARIANTS[name][1] else "drops work: not compared"
        print(f"[variants] {name}: "
              f"{ptxas_usage(log, 'stem_serve_kernel')} (4-byte / 16-byte "
              f"copies); {what}")
    time_in_turns(runs, nbytes, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
