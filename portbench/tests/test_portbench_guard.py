"""The import guard, and the command's refusal without a card."""

import ast
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


def test_shooting_reference_imports_no_program():
    """The shooting reference imports neither JAX nor the port: by its
    own import statements, and by what importing it loads."""
    path = ROOT / "portbench" / "reference" / "shooting.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "math", "torch"}, names
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.shooting; "
            "print(sorted({n.split('.')[0] for n in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'tpu_pathtracer', "
            "'tpu_pathtracer_torch'}))" % str(ROOT))
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
