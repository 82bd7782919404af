"""singleshotpose_tpu_torch — the PyTorch / CUDA port of ``singleshotpose_tpu``.

The single-object serving path runs here on an NVIDIA H100: darknet
``.weights`` → BN folded into the convs → bf16 Darknet-19 forward (its stem
a hand-written CUDA kernel, ``csrc/stem_serve.cu``) → grid decode → best box
→ batched PnP → the 6D pose metrics.  So does the single-object training
path: train-mode Darknet (in bf16 its stem the fused train stem, four
hand-written CUDA kernels in ``csrc/stem_train.cu``) → region loss, whose
target assignment runs a hand-written CUDA kernel
(``csrc/max_corner_confidence.cu``) → SGD → darknet ``.weights`` and
full-state checkpoints.

Module names follow the JAX package, which stays the reference: each module
here names the JAX module it mirrors.  This package imports ``torch`` and
never ``jax``, and nothing of ``singleshotpose_tpu``: the plain-Python host
modules it needs (``config``, ``utils``, ``make_labels``, ``data.pipeline``,
``data.augment``, ``data.prefetch``) are its own copies, held equal to the
originals by ``tests/test_torch_host.py`` and
``tests/test_torch_host_api.py``.

``aot_serving`` is the serving function captured for one static shape (a
CUDA graph on the card), the deployment shape behind a ``MicroBatcher``'s
``{bucket: fn}``.  ``export_serving`` / ``save_exported`` / ``load_serving``
make it one self-contained ``torch.export`` artifact (weights baked in, a
symbolic batch, the kernels as ``torch.library`` custom ops), which loads
with torch and this package's ops and no model code.

The top-level API is the JAX package's (``singleshotpose_tpu/__init__.py``),
each name bound to this package's counterpart and imported at its first
use, so ``import singleshotpose_tpu_torch`` loads no torch module of the
package.  One name differs: JAX's ``make_mesh`` has no counterpart (a torch
rank is a process, not a mesh device); ``make_dp_group(dp, mp)``, its data
× model grid of ranks, is exported under its own name in its place.
"""

__version__ = "0.1.0"

from . import config  # noqa: F401

_LAZY = {
    "DarknetSpec": ("singleshotpose_tpu_torch.models.darknet", "DarknetSpec"),
    "fold_batchnorm": ("singleshotpose_tpu_torch.models.darknet",
                       "fold_batchnorm"),
    "quantize_folded": ("singleshotpose_tpu_torch.models.quantize",
                        "quantize_folded"),
    "calibrate_activations": ("singleshotpose_tpu_torch.models.quantize",
                              "calibrate_activations"),
    "apply_quantized": ("singleshotpose_tpu_torch.models.quantize",
                        "apply_quantized"),
    "load_weights": ("singleshotpose_tpu_torch.weights", "load_weights"),
    "load_weights_until_last": ("singleshotpose_tpu_torch.weights",
                                "load_weights_until_last"),
    "save_weights": ("singleshotpose_tpu_torch.weights", "save_weights"),
    "parse_cfg": ("singleshotpose_tpu_torch.config", "parse_cfg"),
    "read_data_cfg": ("singleshotpose_tpu_torch.config", "read_data_cfg"),
    "yolo_pose_single": ("singleshotpose_tpu_torch.zoo", "yolo_pose_single"),
    "yolo_pose_multi": ("singleshotpose_tpu_torch.zoo", "yolo_pose_multi"),
    "yolo_pose_pretrain": ("singleshotpose_tpu_torch.zoo",
                           "yolo_pose_pretrain"),
    "RegionLossConfig": ("singleshotpose_tpu_torch.ops.losses",
                         "RegionLossConfig"),
    "region_loss": ("singleshotpose_tpu_torch.ops.losses", "region_loss"),
    "decode_grid": ("singleshotpose_tpu_torch.ops.decode", "decode_grid"),
    "best_boxes": ("singleshotpose_tpu_torch.ops.decode", "best_boxes"),
    "pnp": ("singleshotpose_tpu_torch.ops.pnp", "pnp"),
    "pnp_batched": ("singleshotpose_tpu_torch.ops.pnp", "pnp_batched"),
    "run_training": ("singleshotpose_tpu_torch.drivers", "run_training"),
    "run_validation": ("singleshotpose_tpu_torch.drivers", "run_validation"),
    "run_training_multi": ("singleshotpose_tpu_torch.drivers",
                           "run_training_multi"),
    "run_validation_multi": ("singleshotpose_tpu_torch.drivers",
                             "run_validation_multi"),
    "make_train_step": ("singleshotpose_tpu_torch.training",
                        "make_train_step"),
    "init_train_state": ("singleshotpose_tpu_torch.training",
                         "init_train_state"),
    "make_dp_group": ("singleshotpose_tpu_torch.parallel.sharding",
                      "make_dp_group"),
    "make_serving_fn": ("singleshotpose_tpu_torch.serving", "make_serving_fn"),
    "export_serving": ("singleshotpose_tpu_torch.serving", "export_serving"),
    "load_serving": ("singleshotpose_tpu_torch.serving", "load_serving"),
    "aot_serving": ("singleshotpose_tpu_torch.serving", "aot_serving"),
    "save_exported": ("singleshotpose_tpu_torch.serving", "save_exported"),
    "MicroBatcher": ("singleshotpose_tpu_torch.serving", "MicroBatcher"),
}

__all__ = ["config", "__version__"] + sorted(_LAZY)


def __getattr__(name):
    import importlib

    if name in _LAZY:
        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
