"""Vector math, frames and the cosine hemisphere warp on torch tensors.

Counterpart: `tpu_pathtracer/core/math_utils.py` (the slice's subset).
Every function takes arbitrary leading batch dimensions with a trailing
axis of size 3. Three-term sums are written out as `(x0 + x1) + x2` so
the rounding is the same on every device (a reduction kernel may add in
another order).
"""

from __future__ import annotations

import math

import torch

PI = math.pi
TWO_PI = 2.0 * math.pi


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing axis (keeps no dims)."""
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot(v, v))


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Unit vector; safe on zero-length input (returns ~0)."""
    return v * (1.0 / length(v).clamp(min=eps))[..., None]


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection of incident direction d about normal n."""
    return d - 2.0 * dot(d, n)[..., None] * n


def build_frame(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Frisvad orthonormal basis (tangent, bitangent) for unit normals n,
    including the z < -0.9999999 singular branch, branch-free."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    singular = nz < -0.9999999
    a = 1.0 / torch.where(singular, torch.ones_like(nz), 1.0 + nz)
    b = -nx * ny * a
    t_reg = torch.stack([1.0 - nx * nx * a, b, -nx], dim=-1)
    b_reg = torch.stack([b, 1.0 - ny * ny * a, -ny], dim=-1)
    t_sing = n.new_tensor([0.0, -1.0, 0.0]).expand(n.shape)
    b_sing = n.new_tensor([-1.0, 0.0, 0.0]).expand(n.shape)
    s = singular[..., None]
    return torch.where(s, t_sing, t_reg), torch.where(s, b_sing, b_reg)


def from_local(local: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Local (x, y, z) in the Frisvad frame of n -> world direction (unit)."""
    t, b = build_frame(n)
    w = t * local[..., 0:1] + b * local[..., 1:2] + n * local[..., 2:3]
    return normalize(w)


def cosine_sample_hemisphere(
    n: torch.Tensor, u: torch.Tensor, v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Cosine-weighted hemisphere sample (Malley): disk (sqrt(u), 2 pi v),
    z = sqrt(1 - u), lifted through the Frisvad frame of n.

    Returns (dir, pdf): unit directions (..., 3) and cosine pdf (...,).
    """
    r = torch.sqrt(u)
    phi = TWO_PI * v
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt((1.0 - u).clamp(min=0.0))
    d = from_local(torch.stack([x, y, z], dim=-1), n)
    pdf = dot(d, n).clamp(min=0.0) / PI
    return d, pdf
