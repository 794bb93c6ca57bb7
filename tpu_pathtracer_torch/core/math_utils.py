"""Vector math, frames and the cosine hemisphere warp on torch tensors.

Counterpart: `tpu_pathtracer/core/math_utils.py` (all but `cross`).
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


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """ITU-R BT.709 luminance (grid.h:68-70 coefficients)."""
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection of incident direction d about normal n."""
    return d - 2.0 * dot(d, n)[..., None] * n


def build_frame(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Frisvad orthonormal basis (tangent, bitangent) for unit normals n,
    including the z < -0.9999999 singular branch, branch-free: the
    singular frame ((0, -1, 0), (-1, 0, 0)) is picked component by
    component with scalars, so nothing is copied from the host."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    singular = nz < -0.9999999
    a = 1.0 / torch.where(singular, torch.ones_like(nz), 1.0 + nz)
    b = torch.where(singular, -1.0, -nx * ny * a)   # t's y and b's x
    t = torch.stack([torch.where(singular, 0.0, 1.0 - nx * nx * a), b,
                     torch.where(singular, 0.0, -nx)], dim=-1)
    bt = torch.stack([b, torch.where(singular, 0.0, 1.0 - ny * ny * a),
                      torch.where(singular, 0.0, -ny)], dim=-1)
    return t, bt


def to_local(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """World direction -> local (x, y, z) in the Frisvad frame of n."""
    t, b = build_frame(n)
    return torch.stack([dot(d, t), dot(d, b), dot(d, n)], dim=-1)


def from_local(local: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Local (x, y, z) in the Frisvad frame of n -> world direction (unit)."""
    t, b = build_frame(n)
    w = t * local[..., 0:1] + b * local[..., 1:2] + n * local[..., 2:3]
    return normalize(w)


def acos_f32(x: torch.Tensor) -> torch.Tensor:
    """acos of f32 x, evaluated in f64 and rounded to f32."""
    return torch.acos(x.double()).float()


def atan2_f32(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """atan2 of f32 (y, x), evaluated in f64 and rounded to f32.

    acos_f32 and atan2_f32 give the correctly rounded f32 value on every
    device (the f64 error is far below half an f32 ulp), where the f32
    functions of the CPU and of CUDA may differ by an ulp. Angles that
    pick a grid cell need this: a direction from centroid to centroid of
    an axis-aligned scene often lies exactly on a bin edge, and an ulp
    there moves it to the neighbouring cell."""
    return torch.atan2(y.double(), x.double()).float()


def world_to_spherical(
    d: torch.Tensor, n: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Direction -> (theta in [0, pi] from n, phi in [0, 2 pi)) in the
    local frame of n."""
    local = to_local(d, n)
    theta = acos_f32(local[..., 2].clamp(-1.0, 1.0))
    phi = atan2_f32(local[..., 1], local[..., 0])
    return theta, torch.where(phi < 0.0, phi + TWO_PI, phi)


def spherical_to_local(theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """(theta, phi) -> local unit direction (z along the normal)."""
    sin_t = torch.sin(theta)
    return torch.stack(
        [sin_t * torch.cos(phi), sin_t * torch.sin(phi), torch.cos(theta)],
        dim=-1,
    )


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


def cosine_pdf(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """PDF of cosine-weighted hemisphere sampling (grid.h:276-278)."""
    return dot(d, n).clamp(min=0.0) / PI


def uniform_sample_sphere(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Uniform direction on the unit sphere (math_utils.h:94-110):
    z = 1 - 2u, phi = 2 pi v."""
    z = 1.0 - 2.0 * u
    r = torch.sqrt((1.0 - z * z).clamp(min=0.0))
    phi = TWO_PI * v
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def power_heuristic(pdf_a: torch.Tensor, pdf_b: torch.Tensor) -> torch.Tensor:
    """MIS power heuristic pdf_a^2 / (pdf_a^2 + pdf_b^2), 0 where
    pdf_a <= 0 (misPowerHeuristic, integrator.h:91-96)."""
    a2 = pdf_a * pdf_a
    b2 = pdf_b * pdf_b
    w = a2 / (a2 + b2).clamp(min=1e-30)
    return torch.where(pdf_a <= 0.0, 0.0, w)
