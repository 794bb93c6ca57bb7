"""Phase scopes for the kernel profiler.

No counterpart module: the JAX package's trace classifier reads the
op_name metadata XLA attaches to every fused op. Here the code that a
phase consists of runs inside `scope(name)`: the RNG (`core/rng.py`), the
intersection dispatch (`render/integrator.py`), the guided sampler
(`ops/guiding.py`) and the form-factor binning (`render/radiosity.py`).
While `utils.kernel_profile.kernel_profile_traced` traces (`tracing()`),
a scope is a `torch.profiler.record_function` range that encloses the
launches of its kernels; at all other times it is one shared
`contextlib.nullcontext`, so an untraced render launches exactly the
kernels it would without scopes.
"""

from __future__ import annotations

import contextlib
import functools

import torch

PHASES = ("intersection", "rng", "grid_sampling", "binning")

_NULL = contextlib.nullcontext()
_active = False


def scope(name: str):
    """A profiler range named `name` while tracing, else a no-op."""
    if _active:
        return torch.profiler.record_function(name)
    return _NULL


def scoped(name: str):
    """Decorator: the function's body runs inside `scope(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with scope(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def tracing():
    """Open `scope` ranges for the duration of the block (also when it
    raises)."""
    global _active
    _active = True
    try:
        yield
    finally:
        _active = False
