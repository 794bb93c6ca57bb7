"""The import guard, and the command's refusal without a card."""

import subprocess
import sys
from pathlib import Path

from portbench import guard

ROOT = Path(__file__).resolve().parents[2]


def test_guard_by_whole_top_level_name():
    assert guard.forbidden_loaded(["tpu_pathtracer_torch",
                                   "tpu_pathtracer_torch.app",
                                   "torch", "numpy"]) == []
    assert guard.forbidden_loaded(["tpu_pathtracer.app"]) == [
        "tpu_pathtracer"]
    assert guard.forbidden_loaded(["jax", "jax.numpy", "jaxlib.xla",
                                   "flax.linen"]) == ["flax", "jax",
                                                      "jaxlib"]
    assert guard.forbidden_loaded(["jaxtyping", "tpu_pathtracer2"]) == []


def test_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.harness, portbench.check, portbench.control; "
            "import tpu_pathtracer_torch.app; "
            "from portbench import guard; "
            "print(guard.forbidden_loaded())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "cbox_sub3.mis",
         "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
