"""Profiler graphs as inline SVG.

Counterpart: `tpu_pathtracer/viewer/profgraph.py` (copied): the headless
stand-in for the reference's ImGui Profiler window
(ui_windows.h:356-553), a 120-frame FPS history curve with 60/30 fps
guide lines and a stacked per-stage bar of the rolling average stage
times.
"""

from __future__ import annotations

from ..utils.profiler import HISTORY, Profiler

# stage palette, cycled (ui_windows.h:393-399 uses a fixed 6-color set)
_COLORS = ["#4285f4", "#db4437", "#f4b400", "#0f9d58", "#ab47bc",
           "#ff7043"]


def _fps_polyline(frames, w, h, fps_max):
    pts = []
    n = max(len(frames), 2)
    for i, dt in enumerate(frames):
        fps = (1.0 / dt) if dt > 0 else 0.0
        x = i * (w - 1) / (HISTORY - 1)
        y = h - 1 - min(fps / fps_max, 1.0) * (h - 2)
        pts.append(f"{x:.1f},{y:.1f}")
    del n
    return " ".join(pts)


def profiler_svg(profiler: Profiler, width: int = 560,
                 height: int = 260) -> str:
    """Render the profiler state as a standalone SVG document."""
    graph_h = 140
    frames = list(profiler.frame_history)
    fps_now = profiler.fps
    fps_max = max(70.0, *(1.0 / dt for dt in frames if dt > 0)) if frames \
        else 70.0

    def guide_y(fps):
        return graph_h - 1 - min(fps / fps_max, 1.0) * (graph_h - 2)

    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" font-family="monospace" font-size="11">',
        f'<rect width="{width}" height="{graph_h}" fill="#1e1e1e"/>',
        # 60 / 30 fps guides (ui_windows.h:447-456)
        f'<line x1="0" y1="{guide_y(60):.1f}" x2="{width}" '
        f'y2="{guide_y(60):.1f}" stroke="#00ff00" stroke-opacity="0.4"/>',
        f'<line x1="0" y1="{guide_y(30):.1f}" x2="{width}" '
        f'y2="{guide_y(30):.1f}" stroke="#ffff00" stroke-opacity="0.4"/>',
        f'<text x="4" y="{guide_y(60) - 3:.1f}" fill="#00ff00">60</text>',
        f'<text x="4" y="{guide_y(30) - 3:.1f}" fill="#ffff00">30</text>',
    ]
    if frames:
        color = ("#00c800" if fps_now >= 60
                 else "#c8c800" if fps_now >= 30 else "#c80000")
        parts.append(
            f'<polyline fill="none" stroke="{color}" stroke-width="1.5" '
            f'points="{_fps_polyline(frames, width, graph_h, fps_max)}"/>'
        )
    parts.append(
        f'<text x="{width - 110}" y="14" fill="#ddd">'
        f"fps {fps_now:6.1f}</text>"
    )

    # stacked per-stage bar (rolling averages), with legend
    stages = [s for s in profiler.stages.values() if s.count > 0]
    total = sum(s.avg_ms for s in stages) or 1.0
    y0 = graph_h + 14
    x = 0.0
    for i, s in enumerate(stages):
        frac = s.avg_ms / total
        bw = frac * width
        c = _COLORS[i % len(_COLORS)]
        parts.append(
            f'<rect x="{x:.1f}" y="{y0}" width="{bw:.1f}" height="18" '
            f'fill="{c}"/>'
        )
        x += bw
    ly = y0 + 34
    for i, s in enumerate(stages):
        c = _COLORS[i % len(_COLORS)]
        parts.append(f'<rect x="4" y="{ly - 9}" width="10" height="10" '
                     f'fill="{c}"/>')
        parts.append(
            f'<text x="20" y="{ly}" fill="#ddd">{s.name}: '
            f"{s.avg_ms:.2f} ms avg ({s.count})</text>"
        )
        ly += 15
    parts.append("</svg>")
    return "".join(parts)
