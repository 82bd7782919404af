"""YUV 4:2:0 → RGB → resized eval input, on the device.

The port's counterpart of ``singleshotpose_tpu/ops/yuv.py``.  JPEG stores
YCbCr with 2×2-subsampled chroma, so the ``yuv420`` eval transfer copies
Y (H,W) + CbCr (H/2,W/2,2) u8 planes at the frames' native size, 1.5
bytes a pixel, instead of RGB at the eval size (``NativeLoader.
test_batch_yuv420`` decodes them).  The device then does:

  1. the nearest ×2 chroma upsample,
  2. the full-range BT.601 matrix (the JFIF constants libjpeg uses),
  3. a clip to [0, 255] and the center-sample nearest resize to the eval
     shape, as an index gather with ``augment.resize_indices`` (the rows
     and columns ``augment.resize_nearest`` picks; JAX selects with
     one-hot matmuls, a TPU workaround for gathers, and a 0/1 selection
     picks the same values),
  4. the scale to [0, 1] in float32.

Each op rounds on its own, in eager PyTorch on the CPU and the card
alike, and ``/ 255`` is a multiply by f32(1/255) as a device tensor, as
XLA compiles it.  ``tests/test_torch_yuv.py`` holds the result against
JAX's compiled function on the CPU: bit for bit where XLA's code generator
contracts none of the BT.601 matrix's ``y + k·c`` into an FMA (the
identity shape and some resizes), otherwise within 2 f32 ulp at the top
of the [0, 1] range.  Which chains XLA contracts depends on the shape (at
48×64→72×80 the G chain, at the eval shape 480×640→672×672 R and G), so
no fixed formula copies it.
"""

from __future__ import annotations

import torch

from ..data.augment import resize_indices
from ..data.device_augment import INV255

__all__ = ["yuv420_to_rgb_resized"]


def yuv420_to_rgb_resized(y: torch.Tensor, cbcr: torch.Tensor, *, out_w: int,
                          out_h: int) -> torch.Tensor:
    """(B,H,W) u8 luma + (B,H/2,W/2,2) u8 chroma → (B,out_h,out_w,3) f32 in
    [0, 1], on the planes' device."""
    if y.dim() != 3 or cbcr.dim() != 4 or cbcr.shape[-1] != 2 or \
            cbcr.shape[0] != y.shape[0] or y.dtype != torch.uint8 or \
            cbcr.dtype != torch.uint8:
        raise ValueError(f"yuv420 planes must be u8 (B,H,W) and (B,H/2,W/2,2),"
                         f" got {tuple(y.shape)} {y.dtype} and "
                         f"{tuple(cbcr.shape)} {cbcr.dtype}")
    B, H, W = y.shape
    yf = y.float()
    c = cbcr.float() - 128.0
    c = c.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)[:, :H, :W]
    cb, cr = c[..., 0], c[..., 1]
    r = yf + 1.402 * cr
    g = yf - 0.344136286 * cb - 0.714136286 * cr
    b = yf + 1.772 * cb
    rgb = torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0)
    if (H, W) != (out_h, out_w):
        dev = rgb.device
        rgb = rgb.index_select(
            1, torch.from_numpy(resize_indices(H, out_h)).to(dev))
        rgb = rgb.index_select(
            2, torch.from_numpy(resize_indices(W, out_w)).to(dev))
    return rgb * torch.full((), INV255, device=rgb.device)
