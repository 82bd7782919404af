"""On-device batch augmentation — the compute half of the train pipeline
moved off the host.

The port's counterpart of ``singleshotpose_tpu/data/device_augment.py``.
The reference does all augmentation in PIL on DataLoader workers
(reference: ``image.py:46-127``).  Here the host only decodes images and
masks; compositing, crop-jitter, resize and HSV distortion run as PyTorch
ops over the whole batch on the batch's device:

  host: decode img+mask+bg at native size  →  device: composite → crop →
  resize → HSV → u8 batch, batched over B.

Semantics follow ``data/augment.py`` (itself parity with the reference):
zero-padded crop, center-sample nearest resize, mask composite, the PIL
0..255 hue wheel with single wraparound.  The one divergence the JAX
package also carries: crops are normalized affine samples (scale+offset),
so sub-pixel rounding differs from PIL by ≤1 px — parity by metric.

The crop-resize is an index gather (``pleft + floor((x+0.5)·swidth/out_w)``,
out-of-range reads set to 0).  The JAX package runs it as one-hot
selection matmuls, because per-sample gathers serialize on a TPU; a u8
gather is exact, as its int8 selection is.

Rounding as the JAX package's compiled program rounds it, so u8 batches
match it bit for bit: XLA rewrites a division by a constant into a multiply
by the constant's f32 reciprocal (``x / 255.0`` → ``x · f32(1/255)``), so
the port multiplies by those reciprocals where JAX divides by a constant,
and divides (true IEEE division, on the CPU and the card alike) where JAX
divides by a computed value.  Where XLA's CPU compiler contracts a
multiply and an add into one fused multiply-add (``1 - s·f``, ``hq +
dhue·255``), :func:`fma` rounds once as it does; every other op rounds on
its own, with no ``alpha`` that the card could contract.  ``% 6`` is JAX's
remainder: ``fmod`` and a sign fix, written out.

The u8 path returns the HSV chain's final integer ``floor(clip(out·255))``
as u8 — JAX's f32 output is that integer times f32(1/255), which is what
the train step computes from a u8 batch — so a batch moves a quarter of the
bytes and feeds the u8 CUDA graphs of ``training.capture_train_step``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .augment import rand_scale

__all__ = ["AugmentParams", "draw_params", "augment_batch"]


def recip(n) -> float:
    """f32(1/n), the reciprocal XLA multiplies by where JAX divides by the
    constant ``n`` (exactly representable in f32, so a multiply by this
    Python float rounds once on the CPU and the card)."""
    return float(np.float32(1) / np.float32(n))


INV255 = recip(255)
# XLA folds a chain of constant multiplies into one constant, computed in
# f32: (hue·(1/6))·255 and (levels·(1/255))·6
_HUE_LEVELS = float(np.float32(recip(6)) * np.float32(255))
_LEVELS_TO_SIXTHS = float(np.float32(INV255) * np.float32(6))


class AugmentParams(NamedTuple):
    """Per-sample augmentation parameters (host-drawn numpy f32 arrays,
    device-applied)."""
    pleft: np.ndarray    # (B,) crop origin x (pixels, may be negative)
    ptop: np.ndarray     # (B,)
    swidth: np.ndarray   # (B,) crop width in source pixels
    sheight: np.ndarray  # (B,)
    dhue: np.ndarray     # (B,) hue shift in [-1, 1] PIL scale
    dsat: np.ndarray     # (B,) saturation factor
    dexp: np.ndarray     # (B,) value factor


def draw_params(rng: np.random.RandomState, B: int, ow: int, oh: int, *,
                jitter: float, hue: float, saturation: float,
                exposure: float) -> Tuple[AugmentParams, np.ndarray]:
    """Draw reference-distribution parameters for a batch.

    Same per-sample draw order as ``augment.data_augmentation`` so label
    transforms agree.  Returns (params, label_transform (B,4) [dx,dy,sx,sy]).
    """
    dw, dh = int(ow * jitter), int(oh * jitter)
    out = {k: np.zeros(B, np.float32) for k in AugmentParams._fields}
    lab = np.zeros((B, 4), np.float32)
    for b in range(B):
        pleft = rng.randint(-dw, dw + 1)
        pright = rng.randint(-dw, dw + 1)
        ptop = rng.randint(-dh, dh + 1)
        pbot = rng.randint(-dh, dh + 1)
        swidth = ow - pleft - pright
        sheight = oh - ptop - pbot
        _flip = bool(rng.randint(2))          # drawn, never applied (parity)
        sx, sy = swidth / ow, sheight / oh
        out["pleft"][b], out["ptop"][b] = pleft, ptop
        out["swidth"][b], out["sheight"][b] = swidth, sheight
        out["dhue"][b] = rng.uniform(-hue, hue)
        out["dsat"][b] = rand_scale(rng, saturation)
        out["dexp"][b] = rand_scale(rng, exposure)
        lab[b] = [(pleft / ow) / sx, (ptop / oh) / sy, sx, sy]
    return AugmentParams(**out), lab


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; to a card through pinned memory without
    waiting for the copy (the copy is ordered on the current stream, and the
    pinned buffer is held until it completes)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def params_on(params: AugmentParams, device: torch.device) -> torch.Tensor:
    """The seven parameter rows as one (7, B) f32 tensor on ``device``."""
    return upload(np.stack([np.asarray(p, np.float32) for p in params]),
                  device)


def fma(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """f32 ``a·b + c`` rounded once: the fused multiply-add that XLA's CPU
    compiler contracts ``c + a·b`` into.  The product is exact in f64 (24 +
    24 bits); the sum is rounded in f64 to odd (its rounding error, exact
    by TwoSum, decides), and that rounds to the correctly rounded f32
    (53 ≥ 24 + 2 bits), with the same bits on the CPU and the card."""
    p = a.double() * b.double()
    c = c.double() if isinstance(c, torch.Tensor) else float(c)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.copysign(torch.full_like(s, float("inf")), err)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _remainder(x: torch.Tensor, m: float) -> torch.Tensor:
    """``jnp.remainder(x, m)`` for ``m > 0``: ``fmod``, then ``+ m`` where
    the result is nonzero and negative."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & (r < 0), r + m, r)


def crop_index(p: torch.Tensor, ih: int, iw: int, out_w: int, out_h: int):
    """The zero-padded crop + center-sample nearest resize as source rows
    and columns: output (y, x) reads ``(ptop + floor((y+0.5)·sheight/out_h),
    pleft + floor((x+0.5)·swidth/out_w))``.  ``p``: the (7, B) parameter
    rows.  Returns (rows (B, out_h) int64, columns (B, out_w) int64, inside
    (B, out_h, out_w) bool — False where the read falls outside the frame,
    which reads 0)."""
    def axis(p0, size, n_out, n_src):
        c = torch.arange(n_out, dtype=torch.float32, device=p.device) + 0.5
        s = torch.floor(c[None, :] * size[:, None] * recip(n_out)) \
            + p0[:, None]
        inside = (s >= 0) & (s <= n_src - 1)
        return s.clamp(0, n_src - 1).long(), inside

    rows, yin = axis(p[1], p[3], out_h, ih)
    cols, xin = axis(p[0], p[2], out_w, iw)
    return rows, cols, yin[:, :, None] & xin[:, None, :]


def gather(src: torch.Tensor, which: torch.Tensor, rows: torch.Tensor,
           cols: torch.Tensor) -> torch.Tensor:
    """``src[which[b], rows[b, y], cols[b, x]]`` → (B, out_h, out_w, ...)."""
    return src[which[:, None, None], rows[:, :, None], cols[:, None, :]]


def _rgb_to_hsv(rgb, levels=None):
    """H (in sixths of the wheel), S, V of f32 RGB; with ``levels`` (the u8
    values as f32, ``rgb = levels·f32(1/255)``), each channel difference is
    the fused ``fma(a, 1/255, -(b·1/255))`` XLA's CPU compiler makes of it:
    in f64 ``a·(1/255)`` (≤ 32 bits) and its difference with the f32 ``b``
    (a span of ≤ 40 bits) are exact, so one rounding to f32 is the fma's."""
    r, g, b = rgb.unbind(-1)
    mx = rgb.amax(-1)
    mn = rgb.amin(-1)
    d = mx - mn
    safe = torch.where(d == 0, 1.0, d)
    if levels is None:
        gb, br, rg = g - b, b - r, r - g
    else:
        lr, lg, lb = (x.double() * INV255 for x in levels.unbind(-1))
        gb, br, rg = ((x - y.double()).float()
                      for x, y in ((lg, b), (lb, r), (lr, g)))
    h = torch.where(mx == r, _remainder(gb / safe, 6.0),
                    torch.where(mx == g, br / safe + 2.0, rg / safe + 4.0))
    h = torch.where(d == 0, 0.0, h)      # the hue in sixths of the wheel
    s = torch.where(mx == 0, 0.0, d / torch.where(mx == 0, 1.0, mx))
    return h, s, mx


def _hsv_to_rgb(hl, s, v):
    """RGB of hue levels ``hl`` (0..255), saturation and value in [0, 1]."""
    h6 = hl * _LEVELS_TO_SIXTHS
    fl = torch.floor(h6)
    i = _remainder(fl, 6.0).to(torch.int32)
    f = h6 - fl
    p = v * (1.0 - s)
    q = v * fma(-s, f, 1.0)
    t = v * fma(-s, 1.0 - f, 1.0)

    def select(c0, c1, c2, c3, c4, default):
        out = default
        for k, c in reversed(list(enumerate((c0, c1, c2, c3, c4)))):
            out = torch.where(i == k, c, out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def distort_hsv_levels(img: torch.Tensor, p: torch.Tensor,
                       levels=None) -> torch.Tensor:
    """The quantized-u8 HSV pipeline of ``augment.distort_hsv`` on f32
    (B, H, W, 3) in [0, 1], with the per-sample hue/saturation/exposure of
    the (7, B) rows ``p``.  Returns the output levels ``floor(clip(out·255))``
    (f32 integers 0..255)."""
    dhue, dsat, dexp = (x[:, None, None] for x in p[4:7])
    h, s, v = _rgb_to_hsv(img, levels)
    hq = torch.floor(h * _HUE_LEVELS)
    sq = torch.floor(s * 255.0)
    vq = torch.floor(v * 255.0)
    sf = torch.clamp(sq * dsat, 0.0, 255.0)
    vf = torch.clamp(vq * dexp, 0.0, 255.0)
    hf = hq + dhue * 255.0
    hf = torch.where(hf > 255.0, hf - 255.0, hf)
    hf = torch.where(hf < 0.0, hf + 255.0, hf)
    out = _hsv_to_rgb(torch.floor(hf), torch.floor(sf) * INV255,
                      torch.floor(vf) * INV255)
    return torch.floor(torch.clamp(out * 255.0, 0.0, 255.0))


def augment_u8(crop: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """HSV-distort an already composited and cropped u8 batch; u8 out."""
    levels = crop.float()
    return distort_hsv_levels(levels * INV255, p, levels).to(torch.uint8)


def augment_batch(images: torch.Tensor, masks: torch.Tensor,
                  bgs: torch.Tensor, params: AugmentParams, out_w: int,
                  out_h: int) -> torch.Tensor:
    """Full train-sample augmentation for a batch, on the images' device.

    Args:
      images: (B, H, W, 3) uint8 (the production path) or float32 in [0,1],
        at native size.
      masks: (B, H, W, 1) same dtype family; full/ones to skip compositing.
      bgs: (B, H, W, 3) backgrounds pre-resized to the image size.
      params: per-sample crop/HSV parameters (:func:`draw_params`).

    Integer inputs composite as a hard select (``mask >= 128`` keeps the
    foreground) and return (B, out_h, out_w, 3) **uint8**, the HSV chain's
    output levels: JAX's f32 batch is these levels times f32(1/255), bit for
    bit.  LINEMOD masks are binary, so the select equals the reference's
    alpha blend (``image.py:110-127``), and every intermediate before the
    HSV chain is an exact integer.  Float inputs take the alpha-blend path
    (soft masks blend) and return float32 in [0, 1].
    """
    device = images.device
    B, ih, iw = images.shape[:3]
    p = params_on(params, device)
    rows, cols, inside = crop_index(p, ih, iw, out_w, out_h)
    every = torch.arange(B, device=device)
    if not any(t.is_floating_point() for t in (images, masks, bgs)):
        comp = torch.where(masks >= 128, images, bgs)      # exact u8 select
        crop = torch.where(inside[..., None], gather(comp, every, rows, cols),
                           0)
        return augment_u8(crop, p)

    images, masks, bgs = (t if t.is_floating_point() else t.float() * INV255
                          for t in (images, masks, bgs))
    comp = fma(images, masks, bgs * (1.0 - masks))
    crop = torch.where(inside[..., None], gather(comp, every, rows, cols), 0.0)
    return distort_hsv_levels(crop, p) * INV255
