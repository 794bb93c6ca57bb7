"""tpu_pathtracer_torch — the PyTorch + CUDA port of `tpu_pathtracer`.

Counterpart of `tpu_pathtracer/__init__.py`. The JAX package is the
reference; this package runs the same renderer in PyTorch, with each
Pallas kernel on its main path replaced by a kernel written by hand for
NVIDIA Hopper (sources under `csrc/`, built at first use into
`build/tpu_pathtracer_torch/`). It never imports jax.

The device is always explicit: every entry point takes a `device`, and a
CUDA request fails where CUDA is missing instead of running on the CPU.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device) -> torch.device:
    """The torch.device for `device`; raises if it names CUDA and no CUDA
    device is available (there is no fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False"
        )
    return dev
