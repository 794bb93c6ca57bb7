"""The import guard: the benchmark measures the PyTorch + CUDA port and
must not load JAX or the JAX package it was ported from.

A module is matched by its top-level name (the part before the first
dot), compared whole: `tpu_pathtracer_torch` is allowed, `tpu_pathtracer`
is not.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "tpu_pathtracer"})


def forbidden_loaded(modules=None) -> list[str]:
    """Sorted top-level names of loaded modules that are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
