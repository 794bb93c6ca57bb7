"""Counter-based threefry-2x32 RNG, bit for bit the JAX package's.

Counterpart: `tpu_pathtracer/core/rng.py`. A key is the pair of 32-bit
words that `jax.random.key_data` returns, held as a tuple of two Python
ints: keys are derived on the host (`base_key` -> `stream_key` ->
`fold_in`), and only `lane_uniforms` runs on tensors. Every random draw
is a pure function of (key, lane id, sub id), so a render is a pure
function of (seed, pixel, sample, depth), whatever the batch layout.

Tensor arithmetic runs in int64 masked to 32 bits: torch does not shift
uint32 tensors on the CPU. The same function hashes Python ints (for key
derivation) and int64 tensors (for lanes).
"""

from __future__ import annotations

import torch

Key = tuple[int, int]

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
    as `jax.extend.random.threefry_2x32` computes it. x0 and x1 are Python
    ints or int64 tensors holding values in [0, 2**32)."""
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


def fold_in(key: Key, data: int) -> Key:
    """Key data of `jax.random.fold_in(key, data)`."""
    return threefry2x32(key, 0, int(data) & _M32)


def stream_key(key: Key, stream: int) -> Key:
    return fold_in(key, stream)


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
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0
