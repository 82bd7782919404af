"""singleshotpose_tpu_torch — the PyTorch / CUDA port of ``singleshotpose_tpu``.

The single-object serving path runs here on an NVIDIA H100: darknet
``.weights`` → BN folded into the convs → bf16 Darknet-19 forward (its stem
a hand-written CUDA kernel, ``csrc/stem_serve.cu``) → grid decode → best box
→ batched PnP → the 6D pose metrics.  So does the single-object training
path: train-mode Darknet → region loss, whose target assignment runs a
hand-written CUDA kernel (``csrc/max_corner_confidence.cu``) → SGD →
darknet ``.weights`` and full-state checkpoints.

Module names follow the JAX package, which stays the reference: each module
here names the JAX module it mirrors.  This package imports ``torch`` and
never ``jax``; from ``singleshotpose_tpu`` it imports only the modules that
are free of jax (``config``, ``utils``, ``data.pipeline``, ``data.augment``,
``data.prefetch``).
"""

__version__ = "0.1.0"
