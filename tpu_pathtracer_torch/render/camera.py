"""Pinhole look-at camera with orbit controls.

Counterpart: `tpu_pathtracer/render/camera.py`. `CameraController` is
the same host-side numpy code; `Camera` holds the view plane as float32
tensors on one device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields

import numpy as np
import torch

from ..core.math_utils import normalize


def _unit(v):
    return v / np.linalg.norm(v)


@dataclass(frozen=True)
class Camera:
    """View plane: ray(u,v) = llc + u*horizontal + v*vertical - origin."""

    origin: torch.Tensor             # (3,)
    lower_left_corner: torch.Tensor  # (3,)
    horizontal: torch.Tensor         # (3,)
    vertical: torch.Tensor           # (3,)

    def get_rays(self, u: torch.Tensor, v: torch.Tensor):
        """Batched ray generation.

        Args:
            u, v: (...,) screen coordinates in [0, 1] (v=0 is the bottom row).
        Returns:
            (origins, directions): (..., 3) each, directions unit length.
        """
        d = (
            self.lower_left_corner
            + u[..., None] * self.horizontal
            + v[..., None] * self.vertical
            - self.origin
        )
        return self.origin.expand(d.shape), normalize(d)

    def to(self, device: str | torch.device) -> "Camera":
        return Camera(**{
            f.name: getattr(self, f.name).to(device) for f in fields(self)
        })


def camera_from_arrays(
    arrays: dict[str, np.ndarray], device: str | torch.device
) -> Camera:
    """Camera from the fields of a JAX `Camera` as numpy arrays."""
    return Camera(**{
        f.name: torch.tensor(
            np.asarray(arrays[f.name], np.float32), device=device
        )
        for f in fields(Camera)
    })


@dataclass
class CameraController:
    """Host-side mutable camera state (orbit parameters + intrinsics)."""

    lookfrom: np.ndarray
    lookat: np.ndarray
    vup: np.ndarray
    vfov: float       # vertical fov, degrees, top to bottom
    aspect: float
    yaw: float = 90.0
    pitch: float = 0.0

    def __post_init__(self):
        self.lookfrom = np.asarray(self.lookfrom, np.float32)
        self.lookat = np.asarray(self.lookat, np.float32)
        self.vup = np.asarray(self.vup, np.float32)
        self.radius = float(np.linalg.norm(self.lookfrom - self.lookat))

    @staticmethod
    def default(aspect: float = 1.0) -> "CameraController":
        """Reference defaults: eye (0.5,3,8.5) -> (0,2.5,0), fov 40."""
        return CameraController(
            lookfrom=np.array([0.5, 3.0, 8.5]),
            lookat=np.array([0.0, 2.5, 0.0]),
            vup=np.array([0.0, 1.0, 0.0]),
            vfov=40.0,
            aspect=aspect,
        )

    def orbit(self, d_yaw: float = 0.0, d_pitch: float = 0.0,
              d_radius: float = 0.0):
        """Orbit about look_at; pitch clamped to +/-89 degrees."""
        self.yaw += d_yaw
        self.pitch = float(np.clip(self.pitch + d_pitch, -89.0, 89.0))
        self.radius = max(self.radius + d_radius, 1e-3)
        yaw_r = math.radians(self.yaw)
        pitch_r = math.radians(self.pitch)
        self.lookfrom = self.lookat + self.radius * np.array(
            [
                math.cos(pitch_r) * math.cos(yaw_r),
                math.sin(pitch_r),
                math.cos(pitch_r) * math.sin(yaw_r),
            ],
            np.float32,
        )

    def build(self, device: str | torch.device) -> Camera:
        """Compute the view plane on `device`."""
        theta = math.radians(self.vfov)
        half_height = math.tan(theta / 2.0)
        half_width = self.aspect * half_height
        w = _unit(self.lookfrom - self.lookat)
        u = _unit(np.cross(self.vup, w))
        v = np.cross(w, u)
        llc = self.lookfrom - half_width * u - half_height * v - w
        return camera_from_arrays(
            dict(
                origin=self.lookfrom,
                lower_left_corner=llc,
                horizontal=2.0 * half_width * u,
                vertical=2.0 * half_height * v,
            ),
            device,
        )
