"""Counter-based threefry-2x32, as the renderer under test keys its draws.

A plain copy of the published algorithm (Salmon et al., "Parallel random
numbers: as easy as 1, 2, 3", SC 2011; 20 rounds, the rotation table
below) with JAX's key derivation: `base_key(seed)` is (0, seed),
`fold_in(key, x)` hashes the counter (0, x), a uniform is the mantissa
fill of 32 random bits. Arithmetic runs in int64 masked to 32 bits. Key
words are Python ints or int64 tensors that broadcast against the
counters, so many (pixel, pass) lanes can each carry their own key.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

STREAM_PATH = 1
STREAM_FORMFACTOR = 2


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(key, x0, x1):
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def base_key(seed: int):
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed {seed} outside the int32 range")
    return (0, seed & M32)


def fold_in(key, data):
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64)
    else:
        data = int(data)
    return threefry2x32(key, 0, data & M32)


def unit_float(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits (int64) -> float32 in [0, 1)."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def lane_uniforms(key, lane_ids: torch.Tensor, n: int,
                  sub_ids: torch.Tensor) -> torch.Tensor:
    """(B, n) uniforms: block k of lane i hashes (lane id, sub_id * 256 +
    k) and yields draws 2k and 2k + 1. Tensor key words are per lane
    (shape (B,))."""
    b = lane_ids.shape[0]
    half = (n + 1) // 2
    w0 = (lane_ids.to(torch.int64) & M32)[:, None].expand(b, half)
    w1 = torch.arange(half, dtype=torch.int64, device=lane_ids.device)
    w1 = (w1[None, :] + sub_ids.to(torch.int64)[:, None] * 256) & M32
    k0, k1 = key
    if isinstance(k0, torch.Tensor):
        k0, k1 = k0[:, None], k1[:, None]
    y0, y1 = threefry2x32((k0, k1), w0, w1)
    bits = torch.stack([y0, y1], dim=-1).reshape(b, 2 * half)[:, :n]
    return unit_float(bits)


def uniform(key, shape: tuple[int, ...], device=None) -> torch.Tensor:
    """Element i of the row-major flat index hashes (0, i); bits y0 ^ y1.
    Tensor key words of shape K give (K + shape)."""
    k0, k1 = key
    lead: tuple[int, ...] = ()
    if isinstance(k0, torch.Tensor):
        lead, device = tuple(k0.shape), k0.device
        k0, k1 = k0.reshape(-1, 1), k1.reshape(-1, 1)
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32((k0, k1), 0, idx)
    return unit_float(y0 ^ y1).reshape(lead + tuple(shape))
