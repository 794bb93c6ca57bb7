"""Run one cell of the port's benchmark on this machine's first card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Prints, last on standard output, one JSON line: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with --trace 1 its
per-layer metrics), `device`, with --trace 1 `breakdown`, and last
`checks`, the numbers compared with the plain reference beside their
limits; the same numbers are the last lines on standard error. Exits
non-zero, printing no result, without a CUDA card, when the cell asks for
more cards than there are, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# fixed cache directories inside the checkout (the port builds its own
# kernels into build/tpu_pathtracer_torch/)
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ.setdefault("OMP_NUM_THREADS", "4")
# the checkout's root in place of this script's folder, whose module
# names (trace, check) would shadow others
sys.path[0] = str(ROOT)


def _err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    from portbench import guard

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    found = guard.forbidden_loaded()
    if found:
        _err(f"forbidden modules loaded at start: {found}")
        return 4
    import torch

    from portbench import harness, roofline

    cell = harness.load_cell(args.workload)[0]
    if not torch.cuda.is_available():
        _err("no CUDA device: torch.cuda.is_available() is False")
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        _err(f"the cell asks for {cell['chips']} cards, "
             f"{torch.cuda.device_count()} present")
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    _err(f"device {torch.cuda.get_device_name(0)} count "
         f"{torch.cuda.device_count()} power.limit {roofline.power_limit()}")
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda:0", t_start=T_START,
                      log=_err)
    found = guard.forbidden_loaded()
    if found:
        _err(f"forbidden modules loaded by the end of the run: {found}")
        return 4
    for name, c in out["checks"].items():
        _err(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
