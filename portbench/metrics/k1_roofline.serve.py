"""K1, the serving stem (``csrc/stem_serve.cu``): its bound from the serve's
shape (``roofline.k1_bound_s``) over its mean device time a launch in the
traced window."""

from portbench.lib.roofline import k1_bound_s


def read(r):
    t = r.get("trace")
    if r.get("kind") != "serve" or t is None:
        return None
    seconds, launches = t.kernel_seconds("stem_serve_kernel")
    if not launches:
        return None
    return 100.0 * k1_bound_s(r["batch"], r["size"], r["size"]) / (
        seconds / launches)
