"""Counter-based threefry-2x32 RNG, bit for bit the JAX package's.

Counterpart: `tpu_pathtracer/core/rng.py`, plus `jax.random.fold_in` and
`jax.random.uniform` under the JAX package's
`jax_threefry_partitionable=True`. A key is the pair of 32-bit words that
`jax.random.key_data` returns, held as a tuple of two Python ints: keys
are derived on the host (`base_key` -> `stream_key` -> `fold_in`). A key
may also be a pair of int64 tensors, one key per element, so that many
chunks, each with its own key, draw in one tensor pass (`fold_in` with
tensor data, `uniform` with tensor keys). Every random draw of the
renderer is a pure function of (key, lane id, sub id), so a render is a
pure function of (seed, pixel, sample, depth), whatever the batch layout.

Tensor arithmetic runs in int64 masked to 32 bits: torch does not shift
uint32 tensors on the CPU. The same function hashes Python ints (for key
derivation) and int64 tensors (for lanes).
"""

from __future__ import annotations

import math

import torch

from ..utils.trace_scope import scope, scoped

Key = tuple[int, int]   # or a pair of int64 tensors of one shape

# Stream identifiers so distinct consumers of randomness never collide.
STREAM_CAMERA = 0      # pixel-jitter for primary rays
STREAM_PATH = 1        # per-bounce sampling decisions in the integrator
STREAM_FORMFACTOR = 2  # MC form-factor surface samples
STREAM_MISC = 3

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key: Key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter pair (x0, x1) under `key`,
    as `jax.extend.random.threefry_2x32` computes it. The key words, x0
    and x1 are Python ints or int64 tensors (broadcast together) holding
    values in [0, 2**32)."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def base_key(seed: int = 2023) -> Key:
    """Key data of `jax.random.key(seed)` for a seed in int32 range."""
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed {seed} outside the int32 range")
    return (0, seed & _M32)


def fold_in(key: Key, data) -> Key:
    """Key data of `jax.random.fold_in(key, data)`; `data` may be an
    integer tensor, giving one key per element."""
    if not isinstance(data, torch.Tensor):
        data = int(data)
        if not isinstance(key[0], torch.Tensor):
            return threefry2x32(key, 0, data & _M32)
    else:
        data = data.to(torch.int64)
    with scope("rng"):
        return threefry2x32(key, 0, data & _M32)


def stream_key(key: Key, stream: int) -> Key:
    return fold_in(key, stream)


def pixel_key(key: Key, pixel_index, sample_index) -> Key:
    """Key of one (pixel, spp sample) pair: fold_in(fold_in(key, pixel),
    sample); either index may be an integer tensor."""
    return fold_in(fold_in(key, pixel_index), sample_index)


def bounce_key(key: Key, depth) -> Key:
    """Key of one path vertex."""
    return fold_in(key, depth)


def uniforms(key: Key, n: int, shape: tuple[int, ...] = (),
             device: str | torch.device | None = None) -> torch.Tensor:
    """n independent uniforms in [0, 1) with the given batch shape:
    `uniform(key, shape + (n,))`."""
    return uniform(key, tuple(shape) + (n,), device)


@scoped("rng")
def lane_uniforms(
    key: Key,
    lane_ids: torch.Tensor,
    n: int,
    sub_ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, n) float32 uniforms in [0, 1) where row i depends only on
    (key, lane_ids[i], sub_ids[i]).

    One counter-mode sweep, as in the JAX package: block k of lane i
    hashes (lane id, sub_id * 256 + k) and yields draws 2k and 2k + 1;
    bits become floats by the mantissa fill. Requires n <= 512 when
    sub_ids is given."""
    b = lane_ids.shape[0]
    half = (n + 1) // 2
    w0 = (lane_ids.to(torch.int64) & _M32)[:, None].expand(b, half)
    w1 = torch.arange(half, dtype=torch.int64, device=lane_ids.device)
    w1 = w1[None, :].expand(b, half)
    if sub_ids is not None:
        if n > 512:
            raise ValueError("sub_ids packing supports n <= 512")
        w1 = (w1 + sub_ids.to(torch.int64)[:, None] * 256) & _M32
    y0, y1 = threefry2x32(key, w0, w1)
    bits = torch.stack([y0, y1], dim=-1).reshape(b, 2 * half)[:, :n]
    return _unit_float(bits)


@scoped("rng")
def uniform(key: Key, shape: tuple[int, ...],
            device: str | torch.device | None = None) -> torch.Tensor:
    """Bit for bit `jax.random.uniform(key, shape)` (float32 in [0, 1))
    under `jax_threefry_partitionable=True`: element i of the row-major
    flat index hashes the counter (0, i), and its bits are y0 ^ y1.

    With tensor key words of shape K the result is (K + shape): one draw
    of `shape` per key, on the keys' device. With integer key words
    `device` is required."""
    k0, k1 = key
    lead: tuple[int, ...] = ()
    if isinstance(k0, torch.Tensor):
        lead, device = tuple(k0.shape), k0.device
        k0, k1 = k0.reshape(-1, 1), k1.reshape(-1, 1)
    elif device is None:
        raise ValueError("uniform with integer key words needs a device")
    n = math.prod(shape)
    if n >= 2**32:
        raise ValueError("uniform supports fewer than 2**32 draws per key")
    idx = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32((k0, k1), 0, idx)
    return _unit_float(y0 ^ y1).reshape(lead + tuple(shape))


def _unit_float(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits (int64) -> float32 in [0, 1) by the mantissa fill."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0
