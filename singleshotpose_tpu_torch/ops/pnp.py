"""Batched PnP (6D pose from 2D–3D correspondences) in PyTorch.

Mirrors ``singleshotpose_tpu/ops/pnp.py``, batched over frames on the
tensors' device:

  1. Hartley-normalized DLT for the 3×4 projection in K-normalized image
     coordinates (the smallest eigenvector of the 12×12 normal matrix),
  2. orthogonal Procrustes onto SO(3), with the cheirality sign fix — the
     only thing that makes the result independent of the sign ``eigh``
     happens to give the eigenvector,
  3. a fixed number of Levenberg–Marquardt steps on (axis-angle, t), each
     solved by QR of the damped stacked system.

All in f32.  PnP is plain tensor code (``torch.linalg``), not a kernel; on a
CUDA device it runs with TF32 matmuls off, the counterpart of the JAX code's
``default_matmul_precision("highest")``.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch.func import jacfwd, vmap

__all__ = ["so3_exp", "pnp", "pnp_batched"]


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) → rotation matrices (..., 3, 3) by Rodrigues'
    formula, Taylor-guarded for small angles."""
    # keepdim: under torch.func a 0-dim intermediate plus a Python float
    # promotes the tangent to float64; (..., 1) keeps everything f32
    theta2 = (w * w).sum(-1, keepdim=True)
    theta = torch.sqrt(theta2 + 1e-24)
    z = torch.zeros_like(w[..., 0])
    K = torch.stack([z, -w[..., 2], w[..., 1],
                     w[..., 2], z, -w[..., 0],
                     -w[..., 1], w[..., 0], z], dim=-1) \
        .reshape(w.shape[:-1] + (3, 3))
    small = theta2 < 1e-12
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)[..., None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    # K@K == w wᵀ − θ² I for a skew matrix: the outer-product form, as JAX
    return ((1.0 - b * theta2[..., None]) * eye + a[..., None] * K
            + b * (w[..., :, None] * w[..., None, :]))


def _so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (B, 3, 3) → axis-angle (B, 3).  Safe near identity."""
    cos = ((R.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0).clamp(-1.0, 1.0)
    theta = torch.arccos(cos)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    s = torch.where(theta < 1e-6, 0.5 + theta * theta / 12.0,
                    theta / (2.0 * torch.sin(theta) + 1e-24))
    return v * s[..., None]


def _dlt(X: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Direct linear transform: P (B, 3, 4) from X (N, 3) ↔ x (B, N, 2)
    normalized image points, Hartley-normalized on both sides."""
    B, N = x.shape[0], X.shape[0]
    cX = X.mean(0)
    Xc = X - cX
    sX = math.sqrt(3.0) / (torch.sqrt((Xc * Xc).sum(-1).mean()) + 1e-12)
    Xn = Xc * sX
    cx = x.mean(1)                                            # (B, 2)
    xc = x - cx[:, None]
    sx = math.sqrt(2.0) / (torch.sqrt((xc * xc).sum(-1).mean(-1)) + 1e-12)
    xn = xc * sx[:, None, None]

    Xh = torch.cat([Xn, torch.ones_like(Xn[:, :1])], dim=1).expand(B, N, 4)
    zeros = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, zeros, -xn[..., 0:1] * Xh], dim=-1)   # (B, N, 12)
    r2 = torch.cat([zeros, Xh, -xn[..., 1:2] * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=1)                            # (B, 2N, 12)
    _, vecs = torch.linalg.eigh(A.transpose(1, 2) @ A)
    Pn = vecs[..., :, 0].reshape(B, 3, 4)                     # smallest eigval
    # denormalize: x = T2⁻¹ Pn T3 X
    o, l = torch.zeros_like(sx), torch.ones_like(sx)
    T2inv = torch.stack([1.0 / sx, o, cx[:, 0], o, 1.0 / sx, cx[:, 1],
                         o, o, l], dim=-1).reshape(B, 3, 3)
    T3 = torch.zeros((4, 4), dtype=X.dtype, device=X.device)
    T3[:3, :3] = sX * torch.eye(3, dtype=X.dtype, device=X.device)
    T3[:3, 3] = -sX * cX
    T3[3, 3] = 1.0
    return T2inv @ Pn @ T3


def _pose_from_P(P: torch.Tensor, X: torch.Tensor):
    """Project the DLT 3×4s onto SE(3) poses with positive mean depth."""
    depth = X @ P[:, 2, :3].T + P[:, 2, 3]                    # (N, B)
    sign = torch.where(torch.sign(depth).mean(0) < 0, -1.0, 1.0)
    P = P * sign[:, None, None]
    U, S, Vt = torch.linalg.svd(P[:, :, :3])
    d = torch.sign(torch.linalg.det(U @ Vt))
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    R = (U * D[:, None, :]) @ Vt
    scale = 3.0 / ((S * D).sum(-1) + 1e-12)
    return R, P[:, :, 3] * scale[:, None]


def _refine_lm(X: torch.Tensor, x: torch.Tensor, R0: torch.Tensor,
               t0: torch.Tensor, iters: int):
    """Fixed-iteration Levenberg–Marquardt on (axis-angle, t), batched."""

    def residual(params, xi):
        R = so3_exp(params[:3])
        Xc = X @ R.T + params[3:]
        z = Xc[:, 2:3]
        proj = Xc[:, :2] / torch.where(z.abs() < 1e-12, 1e-12, z)
        return (proj - xi).reshape(-1)

    res = vmap(residual)
    jac = vmap(jacfwd(residual))
    params = torch.cat([_so3_log(R0), t0], dim=-1)
    lam = torch.full(params.shape[:1], 1e-4, dtype=x.dtype, device=x.device)
    eye = torch.eye(6, dtype=x.dtype, device=x.device)
    for _ in range(iters):
        r = res(params, x)
        J = jac(params, x)
        # damped least squares by QR of [J; √λ I]: the normal equations
        # square cond(J), which in f32 stalls depth-flat problems
        A = torch.cat([J, torch.sqrt(lam)[:, None, None] * eye], dim=1)
        b = torch.cat([r, torch.zeros_like(r[:, :6])], dim=1)
        Q, R_ = torch.linalg.qr(A)
        delta = torch.linalg.solve_triangular(
            R_, Q.transpose(1, 2) @ b[..., None], upper=True)[..., 0]
        new = params - delta
        improved = (res(new, x) ** 2).sum(-1) < (r ** 2).sum(-1)
        params = torch.where(improved[:, None], new, params)
        lam = torch.where(improved, lam * 0.3, lam * 5.0).clamp(1e-10, 1e6)
    return so3_exp(params[:, :3]), params[:, 3:]


@contextlib.contextmanager
def _no_tf32(device: torch.device):
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def pnp_batched(points_3d, points_2d, camera_matrix, iters: int = 15):
    """Batched PnP: X (N, 3) shared, x (B, N, 2) pixels, K (3, 3) →
    (R (B, 3, 3), t (B, 3)), in f32 on ``points_2d``'s device (the CPU for
    numpy input).  Needs N ≥ 6 non-coplanar points; the pose net gives 9."""
    xs = torch.as_tensor(points_2d, dtype=torch.float32)
    dev = xs.device
    X = torch.as_tensor(points_3d, dtype=torch.float32, device=dev)
    K = torch.as_tensor(camera_matrix, dtype=torch.float32, device=dev)
    with _no_tf32(dev), torch.no_grad():
        uv1 = torch.cat([xs, torch.ones_like(xs[..., :1])], dim=-1)
        xn = (uv1 @ torch.linalg.inv(K).T)[..., :2]
        R0, t0 = _pose_from_P(_dlt(X, xn), X)
        return _refine_lm(X, xn, R0, t0, iters)


def pnp(points_3d, points_2d, camera_matrix, iters: int = 15):
    """Single-instance PnP: X (N, 3), x (N, 2) pixels, K (3, 3) →
    (R (3, 3), t (3,))."""
    R, t = pnp_batched(points_3d, torch.as_tensor(points_2d)[None],
                       camera_matrix, iters)
    return R[0], t[0]
