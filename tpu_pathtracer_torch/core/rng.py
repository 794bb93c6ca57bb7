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
derivation) and int64 tensors (for lanes). `lane_uniforms` also takes a
broadcast key: a pair of one-element int64 tensors, such as the two words
of a device buffer that a CUDA graph reads when it replays (the same bits
as the integer key of the same words).

On a CUDA device a tensor draw (`lane_uniforms`, `uniform`, `fold_in`
with a tensor) is one launch of the hand-written kernel
`csrc/threefry.cu`, bit for bit the eager `threefry2x32` path, which is
the path of CPU tensors; there is no fallback. Each entry point counts
the kernel's launches (`.launches`; an empty draw launches nothing), and
while `utils.trace_scope` records, each launch adds one to the counter
`rng_calls` under `fused` and each eager tensor draw one under `eager`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..utils import trace_scope
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
    like = data if isinstance(data, torch.Tensor) else key[0]
    with scope("rng"):
        if _on_card(like.device):
            return _fold_in_fused(key, data)
        _count("eager")
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
    sub_ids is given. `key` is two integers or a broadcast key: two
    one-element int64 tensors on the lanes' device (on the card the
    kernel reads them there)."""
    if sub_ids is not None and n > 512:
        raise ValueError("sub_ids packing supports n <= 512")
    if _on_card(lane_ids.device):
        return _lane_uniforms_fused(key, lane_ids, n, sub_ids)
    _count("eager")
    return _lane_uniforms_eager(key, lane_ids, n, sub_ids)


def _lane_uniforms_eager(key, lane_ids, n, sub_ids):
    b = lane_ids.shape[0]
    half = (n + 1) // 2
    w0 = (lane_ids.to(torch.int64) & _M32)[:, None].expand(b, half)
    w1 = torch.arange(half, dtype=torch.int64, device=lane_ids.device)
    w1 = w1[None, :].expand(b, half)
    if sub_ids is not None:
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
    k0 = key[0]
    if isinstance(k0, torch.Tensor):
        device = k0.device
    elif device is None:
        raise ValueError("uniform with integer key words needs a device")
    n = math.prod(shape)
    if n >= 2**32:
        raise ValueError("uniform supports fewer than 2**32 draws per key")
    if _on_card(device):
        return _uniform_fused(key, tuple(shape), n, device)
    _count("eager")
    return _uniform_eager(key, tuple(shape), n, device)


def _uniform_eager(key, shape, n, device):
    k0, k1 = key
    lead: tuple[int, ...] = ()
    if isinstance(k0, torch.Tensor):
        lead = tuple(k0.shape)
        k0, k1 = k0.reshape(-1, 1), k1.reshape(-1, 1)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32((k0, k1), 0, idx)
    return _unit_float(y0 ^ y1).reshape(lead + shape)


def _unit_float(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits (int64) -> float32 in [0, 1) by the mantissa fill."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


# --- the fused kernel (csrc/threefry.cu) ------------------------------------

KERNEL_SOURCE = "threefry.cu"      # csrc/ file
_LANE, _UNIFORM, _FOLD = 0, 1, 2   # the kernel's modes


def _count(path: str) -> None:
    trace_scope.count("rng_calls", key=path)


def _on_card(device) -> bool:
    """Whether draws on `device` run as the kernel: on any device but the
    CPU."""
    return torch.device(device).type != "cpu"


def _lane_uniforms_fused(key, lane_ids, n, sub_ids):
    if isinstance(key[0], torch.Tensor):
        if any(k.numel() != 1 for k in key):
            raise ValueError("lane_uniforms on the card takes integer key "
                             "words or a broadcast key of one word each")
        key = _flat(key)
    if lane_ids.ndim != 1:
        raise ValueError(f"lane_ids must be 1-D, got {tuple(lane_ids.shape)}")
    b = lane_ids.shape[0]
    ids = lane_ids.to(torch.int64)
    out = torch.empty((b, n), dtype=torch.float32, device=ids.device)
    sub = None
    if sub_ids is not None:
        sub = torch.broadcast_to(sub_ids.to(torch.int64), (b,))
    _launch(_LANE, key, out, ids=ids, sub=sub, rows=b, n=n)
    return out


def _flat(words):
    """Key words or data as the kernel reads them: flat contiguous int64
    tensors. The callers broadcast them with `torch.broadcast_tensors`:
    `torch.broadcast_shapes` imports sympy at its first call, which costs
    seconds of a process's first draw."""
    return tuple(w.to(torch.int64).reshape(-1).contiguous() for w in words)


def _uniform_fused(key, shape, n, device):
    lead: tuple[int, ...] = ()
    if isinstance(key[0], torch.Tensor):
        key = torch.broadcast_tensors(*key)
        lead = tuple(key[0].shape)
        key = _flat(key)
    out = torch.empty(lead + shape, dtype=torch.float32, device=device)
    _launch(_UNIFORM, key, out, rows=math.prod(lead), n=n)
    return out


def _fold_in_fused(key, data):
    words = torch.broadcast_tensors(
        *(x for x in (*key, data) if isinstance(x, torch.Tensor)))
    ids = None
    if isinstance(data, torch.Tensor):
        ids, data = _flat(words[-1:])[0], 0
    if isinstance(key[0], torch.Tensor):
        key = _flat(words[:2])
    y0 = torch.empty(words[0].shape, dtype=torch.int64,
                     device=words[0].device)
    y1 = torch.empty_like(y0)
    _launch(_FOLD, key, y0, y1, ids=ids, data=data, n=y0.numel())
    return y0, y1


def _launch(mode, key, out, out1=None, **args):
    """One launch of the kernel (`_run`) on out's device; then one more
    launch of the draw's entry point (`.launches`, through
    `trace_scope.launched`) and, while recording,
    one more `rng_calls["fused"]`. An empty draw launches nothing; tensors
    on another device than `out` raise."""
    if out.numel() == 0:
        return
    tensors = [x for x in (*key, out1, args.get("ids"), args.get("sub"))
               if isinstance(x, torch.Tensor)]
    if any(x.device != out.device for x in tensors):
        raise ValueError("the draw's tensors must be on one device")
    _run(mode, key, out, out1, **args)
    trace_scope.launched((lane_uniforms, uniform, fold_in)[mode])
    _count("fused")


def zero_launch_counts() -> None:
    """Set the kernel's launch counters to 0."""
    for fn in (lane_uniforms, uniform, fold_in):
        fn.launches = 0


zero_launch_counts()


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library of csrc/threefry.cu, C signature declared."""
    from ..utils.cuda_build import load

    lib = load(KERNEL_SOURCE)
    p, i, u, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, \
        ctypes.c_longlong
    lib.tpt_threefry.argtypes = [i, u, u, p, p, p, q, p, q, u, q, q, p, p, p]
    lib.tpt_threefry.restype = i
    lib.tpt_error_string.argtypes = [i]
    lib.tpt_error_string.restype = ctypes.c_char_p
    return lib


def _run(mode, key, out, out1=None, *, ids=None, sub=None, data=0, rows=1,
         n=0):
    """The kernel's launch on out's CUDA device and current stream.

    key: two Python ints, or two flat contiguous int64 tensors (a key an
    output row, or an element in `_FOLD`; one word each, broadcast, in
    `_LANE`); ids: the lane ids (`_LANE`) or
    the data (`_FOLD`), 1-D int64 read with its stride; sub: the sub ids,
    1-D int64 read with its stride (0 broadcasts one); data: the scalar
    data of `_FOLD`; out: the (rows, n) float32 draws, or the first key
    word of `_FOLD` and out1 the second."""
    k0, k1 = key
    if isinstance(k0, torch.Tensor):
        words = (0, 0, k0.data_ptr(), k1.data_ptr())
    else:
        words = (int(k0) & _M32, int(k1) & _M32, 0, 0)
    dev = out.device
    if dev.type != "cuda":
        raise ValueError(f"the threefry kernel runs on a CUDA device, "
                         f"not {dev}")
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.tpt_threefry(
            mode, *words,
            0 if ids is None else ids.data_ptr(),
            0 if ids is None else ids.stride(0),
            0 if sub is None else sub.data_ptr(),
            0 if sub is None else sub.stride(0),
            data & _M32, rows, n, out.data_ptr(),
            0 if out1 is None else out1.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"threefry kernel launch failed: "
                           f"{lib.tpt_error_string(err).decode()} ({err})")
