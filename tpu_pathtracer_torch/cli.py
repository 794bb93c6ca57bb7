"""Command-line interface.

Counterpart: `tpu_pathtracer/cli.py`: every Config field is a flag, with
`--out`, `--checkpoint`, `--resume`, `--history-delta` and
`--config-json`, plus `--device` (default cuda). Flags of actions this
package does not port yet are accepted and raise NotImplementedError.

Examples:
    python -m tpu_pathtracer_torch.cli --scene cbox_quads --width 512 \
        --height 512 --spp 64 --out cbox.png
    python -m tpu_pathtracer_torch.cli --subdivision 3 --sampling-mode mis \
        --width 1024 --height 1024 --spp 16 --out mis.png
    python -m tpu_pathtracer_torch.cli --subdivision 3 --integrator \
        radiosity --width 1024 --height 1024 --out rad.png
"""

from __future__ import annotations

import argparse
import sys

from .app import App
from .utils.config import Config
from .utils.logger import configure, get_logger

log = get_logger("CLI")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu_pathtracer_torch",
        description="Path tracer (PyTorch + CUDA port of tpu_pathtracer)",
    )
    Config.add_cli_args(p)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to render on (default: cuda)")
    p.add_argument("--out", type=str, default="out.png",
                   help="output PNG path")
    p.add_argument("--checkpoint", type=str, default="",
                   help="save film+radiosity checkpoint npz here")
    p.add_argument("--resume", type=str, default="",
                   help="resume from a checkpoint npz")
    p.add_argument("--profile", action="store_true",
                   help="stage-profiler summary (not ported yet)")
    p.add_argument("--history-delta", type=int, nargs=2, metavar=("S1", "S2"),
                   default=None,
                   help="render the radiosity-history delta image "
                        "|B(S1)-B(S2)| instead of the integrator output")
    p.add_argument("--delta-boost", type=float, default=1.0,
                   help="brightness boost for --history-delta")
    p.add_argument("--kernel-profile", action="store_true",
                   help="per-phase bounce timing (not ported yet)")
    p.add_argument("--config-json", type=str, default="",
                   help="load Config from a JSON file (flags override)")
    p.add_argument("--verbose", action="store_true")
    return p


_UNPORTED_FLAGS = {
    "profile": "--profile (the stage profiler) is ROADMAP Queue 1 item 19",
    "kernel_profile": "--kernel-profile is ROADMAP Queue 1 item 19",
}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for name, what in _UNPORTED_FLAGS.items():
        if getattr(args, name) not in (None, False, ""):
            raise NotImplementedError(f"not ported yet: {what}")
    if args.verbose:
        import logging

        configure(logging.DEBUG)
    if args.config_json:
        with open(args.config_json) as f:
            cfg = Config.from_json(f.read())
        # flags explicitly passed on the command line override the JSON
        passed = {
            a.lstrip("-").replace("-", "_")
            for a in (argv or sys.argv[1:])
            if a.startswith("--")
        }
        flag_cfg = Config.from_cli_args(args)
        for name in passed:
            if hasattr(cfg, name):
                setattr(cfg, name, getattr(flag_cfg, name))
    else:
        cfg = Config.from_cli_args(args)

    app = App(cfg, device=args.device)
    app.load_scene()
    if args.resume:
        app.prepare()
        app.load_checkpoint(args.resume)
    if args.history_delta is not None:
        image = app.render_history_delta(
            args.history_delta[0], args.history_delta[1], args.delta_boost
        )
    else:
        image = app.render()
    app.save_png(args.out, image)
    if args.checkpoint:
        app.save_checkpoint(args.checkpoint)
    return 0


if __name__ == "__main__":
    sys.exit(main())
