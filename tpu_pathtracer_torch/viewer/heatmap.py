"""Per-primitive sampling-PDF heatmaps.

Counterpart: `tpu_pathtracer/viewer/heatmap.py` (numpy, copied).
Parity with the reference's Grid window (ImGui heatmap of a hovered
primitive's 16x16 PDF, red->yellow->white colormap, from the filtered
buffer or raw radiosity luminance — ui_windows.h:252-350), rendered to
image arrays / PNG instead of an ImGui canvas.
"""

from __future__ import annotations

import numpy as np

from ..core.constants import GRID_RES


def heat_colormap(v: np.ndarray) -> np.ndarray:
    """v in [0,1] -> RGB u8, black -> red -> yellow -> white
    (the reference's 3-stop ramp, ui_windows.h:300-320)."""
    v = np.clip(np.asarray(v, np.float32), 0.0, 1.0)
    r = np.clip(v * 3.0, 0.0, 1.0)
    g = np.clip(v * 3.0 - 1.0, 0.0, 1.0)
    b = np.clip(v * 3.0 - 2.0, 0.0, 1.0)
    return (np.stack([r, g, b], axis=-1) * 255.0).astype(np.uint8)


def grid_heatmap(
    pdf: np.ndarray, prim_idx: int, cell_px: int = 16
) -> np.ndarray:
    """(N, 256) pdf buffer + primitive id -> (16*s, 16*s, 3) u8 heatmap.

    Rows are theta (row 0 = along the normal), columns are phi.
    Normalized by the primitive's max cell (ui_windows.h:285-295)."""
    grid = np.asarray(pdf[prim_idx]).reshape(GRID_RES, GRID_RES)
    peak = grid.max()
    norm = grid / peak if peak > 0 else grid
    img = heat_colormap(norm)
    return np.kron(img, np.ones((cell_px, cell_px, 1), np.uint8))


def top_k_overlay(
    pdf: np.ndarray, prim_idx: int, k: int, cell_px: int = 16
) -> np.ndarray:
    """Heatmap with only the top-K cells lit (the Grid window's top-K
    toggle, ui_windows.h:330-350 / primitive.h:236-271)."""
    grid = np.asarray(pdf[prim_idx]).copy()
    if 0 < k < grid.size:
        thresh = np.sort(grid)[-k]
        grid[grid < thresh] = 0.0
    return grid_heatmap(grid[None], 0, cell_px)
