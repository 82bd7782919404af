"""Model zoo: programmatic builders for the pose-net family.

Mirrors ``singleshotpose_tpu/zoo.py``: the same block dicts (Darknet-19 to a
13×13×1024 map, a passthrough route → 1×1×64 conv → reorg → concat, a 3×3
fuse conv and a 1×1 linear head with ``nA·(2K+1+C)`` filters), built into
this package's jax-free :class:`DarknetSpec`; and the LINEMOD and OCCLUSION
``.data`` renderers.  Beyond the JAX zoo: YOLOv3's Darknet-53 and
three-scale FPN as a pose net (:func:`yolov3_pose`), which the port alone
serves.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

from .models.darknet import DarknetSpec

__all__ = ["yolo_pose_blocks", "yolo_pose_single", "yolo_pose_multi",
           "yolo_pose_pretrain", "yolov3_pose_blocks", "yolov3_pose",
           "YOLOV3_ANCHORS", "MULTI_ANCHORS", "LINEMOD_OBJECTS",
           "LINEMOD_DIAMETERS", "linemod_datacfg", "OCCLUSION_OBJECTS",
           "occlusion_datacfg"]

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


# yolov3.cfg's nine anchor (w, h) pairs in pixels, as written there; the
# pose decode uses none
YOLOV3_ANCHORS = ("10,13,  16,30,  33,23,  30,61,  62,45,  59,119,  "
                  "116,90,  156,198,  373,326")

# Darknet-53: (filters of the stride-2 conv, residual blocks) a stage
_DARKNET53_STAGES: Tuple[Tuple[int, int], ...] = (
    (64, 1), (128, 2), (256, 8), (512, 8), (1024, 4))


def _conv_s(filters: int, size: int, stride: int = 1,
            activation: str = "leaky", bn: bool = True) -> Dict[str, str]:
    """A conv block as ``parse_cfg`` reads yolov3.cfg's: ``batch_normalize``
    first (the parser's default "0" where the cfg has none)."""
    b = _conv(filters, size, activation, bn)
    b["stride"] = str(stride)
    return b


def yolov3_pose_blocks(*, num_classes: int = 1,
                       num_keypoints: int = 9) -> List[Dict[str, str]]:
    """The blocks of darknet's ``cfg/yolov3.cfg`` (Redmon & Farhadi 2018:
    Darknet-53, then a three-scale FPN neck with a ``[yolo]`` head at 1/32,
    1/16 and 1/8), as ``parse_cfg`` reads them, made a pose net the way
    SingleShotPose made ``yolo-pose.cfg`` of ``yolo-voc.cfg``: each 255-wide
    detection conv becomes 3 anchors × (2K + 1 + C) filters, each ``[yolo]``
    takes ``classes=C``, and ``[net]`` gains ``num_keypoints=K``.  Every
    other width, the depth and the 608² input are as published."""
    head = 3 * (2 * num_keypoints + 1 + num_classes)
    net = {"type": "net", "batch": "64", "subdivisions": "16",
           "width": "608", "height": "608", "channels": "3",
           "momentum": "0.9", "decay": "0.0005", "angle": "0",
           "saturation": "1.5", "exposure": "1.5", "hue": ".1",
           "learning_rate": "0.001", "burn_in": "1000",
           "max_batches": "500200", "policy": "steps",
           "steps": "400000,450000", "scales": ".1,.1",
           "num_keypoints": str(num_keypoints)}
    blocks: List[Dict[str, str]] = [net, _conv_s(32, 3)]
    for filters, repeats in _DARKNET53_STAGES:
        blocks.append(_conv_s(filters, 3, stride=2))
        for _ in range(repeats):
            blocks += [_conv_s(filters // 2, 1), _conv_s(filters, 3),
                       {"type": "shortcut", "from": "-3",
                        "activation": "linear"}]
    # the neck: a scale's five convs, its 3×3 and 1×1 head convs and
    # [yolo]; then back to the fifth conv, 1×1, ×2 up and concatenated
    # with the trunk's output of the next finer stage (layers 61, 36)
    for scale, (width, mask, skip) in enumerate(
            ((512, "6,7,8", 61), (256, "3,4,5", 36), (128, "0,1,2", None))):
        for _ in range(2):
            blocks += [_conv_s(width, 1), _conv_s(2 * width, 3)]
        blocks += [_conv_s(width, 1), _conv_s(2 * width, 3),
                   _conv_s(head, 1, activation="linear", bn=False),
                   {"type": "yolo", "mask": mask, "anchors": YOLOV3_ANCHORS,
                    "classes": str(num_classes), "num": "9", "jitter": ".3",
                    "ignore_thresh": ".7", "truth_thresh": "1",
                    "random": "1"}]
        if skip is not None:
            blocks += [{"type": "route", "layers": "-4"},
                       _conv_s(width // 2, 1),
                       {"type": "upsample", "stride": "2"},
                       {"type": "route", "layers": f"-1, {skip}"}]
    return blocks


def yolov3_pose(**overrides) -> DarknetSpec:
    """YOLOv3 as a single-object pose net (≡ ``cfg/yolov3.cfg`` with 60-wide
    heads): 107 layers, three [yolo] heads of 3 anchors, 1 class."""
    return DarknetSpec(yolov3_pose_blocks(**overrides))


# Published LINEMOD object diameters in meters (reference: cfg/<obj>.data:7,
# e.g. ape.data "diam = 0.103"); the order is the 13 class ids.
LINEMOD_DIAMETERS: Dict[str, float] = {
    "ape": 0.103, "benchvise": 0.286908, "cam": 0.173, "can": 0.202,
    "cat": 0.155, "driller": 0.262, "duck": 0.109, "eggbox": 0.176364,
    "glue": 0.176, "holepuncher": 0.162, "iron": 0.303153,
    "lamp": 0.285155, "phone": 0.213,
}
LINEMOD_OBJECTS: Tuple[str, ...] = tuple(LINEMOD_DIAMETERS)


def linemod_datacfg(obj: str, linemod_root: str = "LINEMOD",
                    backup_root: str = "backup") -> str:
    """Render a per-object ``.data`` config (≡ ``cfg/<obj>.data``) for a
    LINEMOD tree at ``linemod_root`` — parseable by ``read_data_cfg``."""
    if obj not in LINEMOD_DIAMETERS:
        raise ValueError(f"unknown LINEMOD object {obj!r}; "
                         f"choose from {sorted(LINEMOD_DIAMETERS)}")
    r = f"{linemod_root}/{obj}"
    return (f"train = {r}/train.txt\n"
            f"valid = {r}/test.txt\n"
            f"backup = {backup_root}/{obj}\n"
            f"mesh = {r}/{obj}.ply\n"
            f"tr_range = {r}/training_range.txt\n"
            f"name = {obj}\n"
            f"diam = {LINEMOD_DIAMETERS[obj]}\n"
            "gpus = 0\n"
            "width = 640\n"
            "height = 480\n"
            "fx = 572.4114\n"
            "fy = 573.5704\n"
            "u0 = 325.2611\n"
            "v0 = 242.0489\n")


# Objects with OCCLUSION test annotations (the reference ships one
# ``<obj>_occlusion.data`` per entry, multi_obj_pose_estimation/cfg/).
OCCLUSION_OBJECTS: Tuple[str, ...] = (
    "ape", "can", "cat", "driller", "duck", "eggbox", "glue", "holepuncher")

# Objects in the combined occlusion.data numbered sweep (no eggbox there,
# reference multi_obj_pose_estimation/cfg/occlusion.data:2-8).
_OCCLUSION_SWEEP: Tuple[str, ...] = (
    "ape", "can", "cat", "driller", "duck", "glue", "holepuncher")

_SHARED_CAMERA = ("gpus = 0\n"
                  "im_width = 640\n"
                  "im_height = 480\n"
                  "fx = 572.4114\n"
                  "fy = 573.5704\n"
                  "u0 = 325.2611\n"
                  "v0 = 242.0489\n")


def occlusion_datacfg(obj: Optional[str] = None,
                      linemod_root: str = "../LINEMOD",
                      backup_root: str = "backup_multi",
                      train_list: str = "cfg/train_occlusion.txt") -> str:
    """Render OCCLUSION ``.data`` artifacts for ``read_data_cfg``.

    ``obj=None`` → the combined multi-object config with numbered
    ``valid<i>``/``mesh<i>``/``diam<i>`` keys (≡ reference
    ``multi_obj_pose_estimation/cfg/occlusion.data``; index = LINEMOD class
    id + 1, e.g. ``valid1`` = ape, ``valid4`` = can).  ``obj=<name>`` → the
    per-object eval config (≡ ``<obj>_occlusion.data``), plus a ``class_id``
    key so the eval driver can class-pick boxes directly.
    """
    if obj is None:
        ids = [(o, LINEMOD_OBJECTS.index(o) + 1) for o in _OCCLUSION_SWEEP]
        lines = [f"train  = {train_list}"]
        lines += [f"valid{i} = {linemod_root}/{o}/test_occlusion.txt"
                  for o, i in ids]
        lines.append(f"backup = {backup_root}")
        lines += [f"mesh{i} = {linemod_root}/{o}/{o}.ply" for o, i in ids]
        lines += [f"diam{i} = {LINEMOD_DIAMETERS[o]}" for o, i in ids]
        return "\n".join(lines) + "\n" + _SHARED_CAMERA
    if obj not in OCCLUSION_OBJECTS:
        raise ValueError(f"no OCCLUSION annotations for {obj!r}; "
                         f"choose from {OCCLUSION_OBJECTS}")
    r = f"{linemod_root}/{obj}"
    return (f"valid = {r}/test_occlusion.txt\n"
            f"mesh = {r}/{obj}.ply\n"
            f"backup = {backup_root}\n"
            f"name = {obj}\n"
            f"diam = {LINEMOD_DIAMETERS[obj]}\n"
            f"class_id = {LINEMOD_OBJECTS.index(obj)}\n"
            + _SHARED_CAMERA)


_BUILDERS = {"yolo-pose": yolo_pose_single,
             "yolo-pose-multi": yolo_pose_multi,
             "yolo-pose-pre": yolo_pose_pretrain,
             "yolov3-pose": yolov3_pose}


def _resolve_model(modelcfg: Union[str, DarknetSpec]) -> DarknetSpec:
    """A zoo name (``yolo-pose``, ``yolo-pose-multi``, ``yolo-pose-pre``,
    ``yolov3-pose``), a
    darknet ``.cfg`` path, or a built spec → a :class:`DarknetSpec`."""
    if isinstance(modelcfg, DarknetSpec):
        return modelcfg
    if modelcfg in _BUILDERS:
        return _BUILDERS[modelcfg]()
    return DarknetSpec.from_cfg(modelcfg)
