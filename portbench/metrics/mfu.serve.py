"""The serve's whole share of the bf16 peak: the benchmark's conv FLOPs a
frame times the frames answered in the traced window, over the window's
seconds times 989 TFLOP/s."""

from portbench.lib.roofline import BF16_FLOPS


def read(r):
    if r.get("kind") != "serve" or r.get("trace") is None:
        return None
    return 100.0 * r["flops_per_frame"] * r["frames_traced"] / (
        r["trace"].window_s * BF16_FLOPS)
