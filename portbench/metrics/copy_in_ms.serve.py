"""The frames' copy into the serving graph's input (``serving.aot_serving``
copies each batch from pageable host memory): device ms of host-to-card
copies a batch answered in the traced window."""


def read(r):
    t = r.get("trace")
    if r.get("kind") != "serve" or t is None or not r.get("frames_traced"):
        return None
    seconds, copies = t.kernel_seconds("Memcpy HtoD")
    if not copies:
        return None
    return 1e3 * seconds / (r["frames_traced"] / r["batch"])
