"""The serve's copy-in on the host: mean ms a call of the program's span
``ssp.serve.copy_in`` (``serving.aot_serving``'s check of the frames and
their copy from pageable memory into the graph's input) in the traced
window: how long the host is held staging the frames and waiting for the
stream."""

from portbench.lib.program_spans import mean_host_ms


def read(r):
    return mean_host_ms(r, "ssp.serve.copy_in")
