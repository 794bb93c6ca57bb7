"""Progressive accumulation film.

Counterpart: `tpu_pathtracer/render/film.py`. The film is the linear
radiance sum plus the sample count and the pass counter (which keys the
RNG of the next pass). Unlike the JAX film it is updated in place: a
pass adds into `accum` instead of allocating a new (H, W, 3) sum. `save`
and `load` use the JAX package's npz format (keys accum, spp, passes), so
a film moves between the two packages in either direction.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.tonemap import tonemap_pt


@dataclass
class Film:
    accum: torch.Tensor   # (H, W, 3) f32 linear radiance sum (row 0 = v=0)
    spp: int = 0          # samples accumulated per pixel
    passes: int = 0       # render passes folded in

    @staticmethod
    def create(width: int, height: int,
               device: str | torch.device) -> "Film":
        return Film(
            accum=torch.zeros((height, width, 3), dtype=torch.float32,
                              device=device),
        )

    @property
    def height(self) -> int:
        return self.accum.shape[0]

    @property
    def width(self) -> int:
        return self.accum.shape[1]

    def add_pass(self, radiance: torch.Tensor, spp: int) -> None:
        """Fold one pass's (H, W, 3) radiance sum over `spp` samples in."""
        self.accum += radiance
        self.spp += spp
        self.passes += 1

    def mean_radiance(self) -> torch.Tensor:
        return self.accum / float(max(self.spp, 1))

    def to_srgb(self) -> torch.Tensor:
        """(H, W, 3) uint8, row 0 still the bottom scanline."""
        return tonemap_pt(self.mean_radiance())

    def to_image(self) -> np.ndarray:
        """(H, W, 3) uint8 with row 0 = top, ready for PNG export."""
        return self.to_srgb().cpu().numpy()[::-1]

    # --- checkpoint / resume ---

    def save(self, path: str) -> None:
        np.savez(
            path,
            accum=self.accum.cpu().numpy(),
            spp=np.asarray(self.spp, np.int32),
            passes=np.asarray(self.passes, np.int32),
        )

    @staticmethod
    def load(path: str, device: str | torch.device) -> "Film":
        with np.load(path) as z:
            return Film(
                accum=torch.from_numpy(z["accum"]).to(device),
                spp=int(z["spp"]),
                passes=int(z["passes"]),
            )
