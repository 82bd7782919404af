"""Model zoo: programmatic builders for the pose-net family.

Mirrors ``singleshotpose_tpu/zoo.py``: the same block dicts (Darknet-19 to a
13×13×1024 map, a passthrough route → 1×1×64 conv → reorg → concat, a 3×3
fuse conv and a 1×1 linear head with ``nA·(2K+1+C)`` filters), built into
this package's jax-free :class:`DarknetSpec`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

from .models.darknet import DarknetSpec

__all__ = ["yolo_pose_blocks", "yolo_pose_single", "yolo_pose_multi",
           "yolo_pose_pretrain", "MULTI_ANCHORS"]

# 5 anchor (w, h) pairs in grid units (yolo-pose-multi.cfg:240)
MULTI_ANCHORS: Tuple[float, ...] = (
    1.4820, 2.2412, 2.0501, 3.1265, 2.3946, 4.6891, 3.1018, 3.9910,
    3.4879, 5.8851)

# (filters, kernel size) runs between 2×2/2 maxpools — the Darknet-19 plan.
_BACKBONE_PLAN: Tuple[Tuple[Tuple[int, int], ...], ...] = (
    ((32, 3),),
    ((64, 3),),
    ((128, 3), (64, 1), (128, 3)),
    ((256, 3), (128, 1), (256, 3)),
    ((512, 3), (256, 1), (512, 3), (256, 1), (512, 3)),
    ((1024, 3), (512, 1), (1024, 3), (512, 1), (1024, 3)),
)


def _conv(filters: int, size: int, activation: str = "leaky",
          bn: bool = True) -> Dict[str, str]:
    return {"type": "convolutional", "batch_normalize": str(int(bn)),
            "filters": str(filters), "size": str(size), "stride": "1",
            "pad": "1", "activation": activation}


def _maxpool() -> Dict[str, str]:
    return {"type": "maxpool", "size": "2", "stride": "2"}


def yolo_pose_blocks(*, num_classes: int = 1, num_anchors: int = 1,
                     anchors: Sequence[float] = (), num_keypoints: int = 9,
                     batch: int = 8, learning_rate: float = 0.001,
                     momentum: float = 0.9, decay: float = 0.0005,
                     steps: Sequence[float] = (-1, 80, 160),
                     scales: Sequence[float] = (0.1, 0.1, 0.1),
                     max_epochs: int = 500, conf_thresh: float = 0.1,
                     test_size: int = 672, train_size: int = 416,
                     object_scale: float = 5.0, noobject_scale: float = 0.1,
                     hue: float = 0.1, saturation: float = 1.5,
                     exposure: float = 1.5) -> List[Dict[str, str]]:
    """Full block list for a pose net; head width = nA·(2K+1+C)."""
    head_filters = num_anchors * (2 * num_keypoints + 1 + num_classes)
    net = {
        "type": "net", "batch": str(batch), "height": str(train_size),
        "width": str(train_size), "channels": "3",
        "num_keypoints": str(num_keypoints),
        "momentum": str(momentum), "decay": str(decay),
        "learning_rate": str(learning_rate),
        "steps": ",".join(str(s) for s in steps),
        "scales": ",".join(str(s) for s in scales),
        "max_epochs": str(max_epochs), "conf_thresh": str(conf_thresh),
        "test_width": str(test_size), "test_height": str(test_size),
        "hue": str(hue), "saturation": str(saturation),
        "exposure": str(exposure),
    }
    blocks: List[Dict[str, str]] = [net]
    for i, run in enumerate(_BACKBONE_PLAN):
        for f, k in run:
            blocks.append(_conv(f, k))
        if i < len(_BACKBONE_PLAN) - 1:
            blocks.append(_maxpool())
    # detection head with passthrough (route −9 reaches the 26×26×512 layer)
    blocks.append(_conv(1024, 3))
    blocks.append(_conv(1024, 3))
    blocks.append({"type": "route", "layers": "-9"})
    blocks.append(_conv(64, 1))
    blocks.append({"type": "reorg", "stride": "2"})
    blocks.append({"type": "route", "layers": "-1,-4"})
    blocks.append(_conv(1024, 3))
    blocks.append(_conv(head_filters, 1, activation="linear", bn=False))
    blocks.append({
        "type": "region",
        "anchors": ", ".join(f"{a:.4f}" for a in anchors) if anchors else "",
        "classes": str(num_classes), "coords": str(2 * num_keypoints),
        "num": str(num_anchors), "object_scale": str(object_scale),
        "noobject_scale": str(noobject_scale), "class_scale": "1",
        "coord_scale": "1", "thresh": "0.6", "softmax": "1", "rescore": "1",
        "bias_match": "1",
    })
    return blocks


def yolo_pose_single(**overrides) -> DarknetSpec:
    """Single-object LINEMOD net (≡ ``cfg/yolo-pose.cfg``): 1 class, 1
    trivial anchor, 20-channel head."""
    return DarknetSpec(yolo_pose_blocks(**overrides))


def yolo_pose_multi(**overrides) -> DarknetSpec:
    """Multi-object OCCLUSION net (≡ ``yolo-pose-multi.cfg``): 13 classes,
    5 anchors, 160-channel head."""
    kw = dict(num_classes=13, num_anchors=5, anchors=MULTI_ANCHORS,
              batch=32, steps=(-1, 100, 20000, 30000),
              scales=(0.1, 10, 0.1, 0.1), conf_thresh=0.05)
    kw.update(overrides)
    return DarknetSpec(yolo_pose_blocks(**kw))


def yolo_pose_pretrain(**overrides) -> DarknetSpec:
    """Confidence-pretrain variant (≡ ``cfg/yolo-pose-pre.cfg``): 13-class
    32-channel head, confidence loss structurally off."""
    kw = dict(num_classes=13, num_anchors=1, batch=32,
              steps=(-1, 50, 1000, 2000), scales=(0.1, 10, 0.1, 0.1),
              object_scale=0.0, noobject_scale=0.0)
    kw.update(overrides)
    return DarknetSpec(yolo_pose_blocks(**kw))


_BUILDERS = {"yolo-pose": yolo_pose_single,
             "yolo-pose-multi": yolo_pose_multi,
             "yolo-pose-pre": yolo_pose_pretrain}


def _resolve_model(modelcfg: Union[str, DarknetSpec]) -> DarknetSpec:
    """A zoo name (``yolo-pose``, ``yolo-pose-multi``, ``yolo-pose-pre``), a
    darknet ``.cfg`` path, or a built spec → a :class:`DarknetSpec`."""
    if isinstance(modelcfg, DarknetSpec):
        return modelcfg
    if modelcfg in _BUILDERS:
        return _BUILDERS[modelcfg]()
    return DarknetSpec.from_cfg(modelcfg)
