"""The share of the serve's traced window with no kernel, copy or set on
the card (the union of the device's intervals)."""


def read(r):
    t = r.get("trace")
    if r.get("kind") != "serve" or t is None or t.device_events == 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
