"""The control of a cell's check: the plain reference in the next precision
below the configuration's (the traffic file's `check.control`: "tf32"
runs the solve's products in TF32, "bf16" rounds every ray-triangle
test's inputs to bfloat16) put in the program's place, judged against
the float32 reference exactly as a run's outputs are. A sound check
reads it above the limit on every seed.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3
        [--passes N] [--device cuda:0]

`--passes` is the number of passes a run's film holds (the default:
what one run of `run_seconds` gave on an H100, in the traffic file's
`check.passes`). Prints one JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def control_numbers(cell: str, seed: int, passes: int, device,
                    overrides=None) -> dict:
    """{name: {"value", "limit"}} of the control of `cell` on `seed`."""
    import torch

    from portbench import check, harness

    _, config, traffic, _, _ = harness.load_cell(cell)
    cfg = harness.app_config(config, traffic, seed, overrides)
    got = check.numbers(traffic["unit"], cfg, traffic, seed, passes, None,
                        torch.device(device), traffic["check"]["control"])
    limits = traffic["check"]["limits"]
    return {k: {"value": v, "limit": limits[k]} for k, v in got.items()}


def main(argv=None) -> int:
    import torch

    from portbench import harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--passes", type=int, default=None)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    traffic = harness.load_cell(args.workload)[2]
    passes = args.passes or traffic["check"].get("passes", 1)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = control_numbers(args.workload, seed, passes, args.device)
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              passes=passes, control=traffic["check"]
                              ["control"], checks=out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
