"""The port's counter-based RNG against the JAX package's: key derivation
and `lane_uniforms` bits are held bitwise. Then the dispatch between the
eager path and the fused kernel (`csrc/threefry.cu`): CPU tensors take
the eager path, the `rng_calls` counter, and the fused path's argument
handling against the eager path on the CPU through `emulate_launch`, a
numpy model of the kernel. The tests marked `card` hold the kernel
itself bit for bit to the eager path on a CUDA card (the machine with
the card has no JAX: there this file's JAX tests fail and the card tests
run):
`python -m pytest tests/test_torch_rng.py --noconftest -q -k card`."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from tpu_pathtracer.core import rng as jrng
except ImportError:     # the card's machine: only the card tests run there
    jax = jnp = jrng = None
from tpu_pathtracer_torch.core import rng as trng
from tpu_pathtracer_torch.utils import trace_scope

torch.set_num_threads(1)

# (seed, stream, fold-in chain) -> keys as the renderer derives them
KEY_PATHS = [
    (2023, trng.STREAM_PATH, (0, 7)),
    (2023, trng.STREAM_CAMERA, (3, 101)),
    (7, trng.STREAM_PATH, (1, 7)),
    (0, trng.STREAM_MISC, ()),
    (123456789, trng.STREAM_FORMFACTOR, (2**31 - 1, 5)),
]


def _keys(seed, stream, chain):
    jk, tk = jrng.base_key(seed), trng.base_key(seed)
    jk, tk = jrng.stream_key(jk, stream), trng.stream_key(tk, stream)
    for data in chain:
        jk, tk = jax.random.fold_in(jk, data), trng.fold_in(tk, data)
    return jk, tk


@pytest.mark.parametrize("path", KEY_PATHS)
def test_key_derivation_matches_key_data(path):
    jk, tk = _keys(*path)
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(jk)), np.asarray(tk, np.uint32)
    )


@pytest.mark.parametrize("seed", [0, 1, 2023, 2**31 - 1, -5])
def test_base_key(seed):
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(jrng.base_key(seed))),
        np.asarray(trng.base_key(seed), np.uint32),
    )


def test_base_key_rejects_out_of_range_seed():
    with pytest.raises(ValueError):
        trng.base_key(2**31)


@pytest.mark.parametrize("path", KEY_PATHS)
@pytest.mark.parametrize("n", [2, 3, 6])
@pytest.mark.parametrize("with_sub", [False, True])
def test_lane_uniforms_bitwise(path, n, with_sub):
    jk, tk = _keys(*path)
    g = np.random.default_rng(n)
    lanes = g.integers(0, 1 << 20, size=777).astype(np.int32)
    sub = g.integers(0, 5000, size=777).astype(np.int32) if with_sub \
        else None
    want = np.asarray(jrng.lane_uniforms(
        jk, jnp.asarray(lanes), n,
        sub_ids=None if sub is None else jnp.asarray(sub),
    ))
    got = trng.lane_uniforms(
        tk, torch.from_numpy(lanes), n,
        sub_ids=None if sub is None else torch.from_numpy(sub),
    ).numpy()
    assert got.dtype == np.float32 and got.shape == (777, n)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (got >= 0).all() and (got < 1).all()


def test_lane_uniforms_depend_only_on_lane_and_sub_id():
    _, tk = _keys(*KEY_PATHS[0])
    lanes = torch.arange(1000)
    sub = torch.arange(1000) % 17
    full = trng.lane_uniforms(tk, lanes, 3, sub_ids=sub)
    perm = torch.randperm(1000, generator=torch.Generator().manual_seed(0))
    part = trng.lane_uniforms(tk, lanes[perm], 3, sub_ids=sub[perm])
    assert torch.equal(part, full[perm])


def test_sub_ids_limit():
    with pytest.raises(ValueError):
        trng.lane_uniforms((0, 1), torch.arange(4), 513,
                           sub_ids=torch.zeros(4, dtype=torch.int64))


@pytest.mark.parametrize("path", KEY_PATHS)
@pytest.mark.parametrize("shape", [(4, 16, 64), (7,), (3, 5), (4, 1, 33)])
def test_uniform_bitwise(path, shape):
    """rng.uniform is jax.random.uniform (threefry partitionable) bit for
    bit, on the key chains the solver and the radiosity view use."""
    jk, tk = _keys(*path)
    want = np.asarray(jax.random.uniform(jk, shape))
    got = trng.uniform(tk, shape, "cpu").numpy()
    assert got.shape == shape and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_uniform_integer_keys_need_a_device():
    """Integer key words carry no device, so uniform refuses to pick one."""
    with pytest.raises(ValueError, match="needs a device"):
        trng.uniform(trng.base_key(3), (2, 4))


def test_uniform_with_tensor_keys_draws_per_key():
    """fold_in with tensor data gives one key per element, and uniform
    with those keys draws each key's block as a separate call would."""
    jk, tk = _keys(*KEY_PATHS[4])
    chunks = torch.tensor([0, 3, 2**31 - 1, 17])
    keys = trng.fold_in(tk, chunks)
    got = trng.uniform(trng.fold_in(keys, 5), (4, 2, 9))
    assert got.shape == (4, 4, 2, 9)
    for i, c in enumerate(chunks.tolist()):
        want = np.asarray(jax.random.uniform(
            jax.random.fold_in(jax.random.fold_in(jk, c), 5), (4, 2, 9)))
        np.testing.assert_array_equal(got[i].numpy(), want)
        assert trng.fold_in(tk, c) == (int(keys[0][i]), int(keys[1][i]))


@pytest.mark.parametrize("shape,n", [((), 6), ((4, 3), 2), ((1000,), 1)])
def test_uniforms_pixel_and_bounce_keys_match_jax(shape, n):
    """`uniforms` bitwise `jax.random.uniform(key, shape + (n,))` under
    the keys `pixel_key` and `bounce_key` derive (integer and tensor
    pixel indices), as the JAX package's helpers compute them."""
    jk = jrng.bounce_key(jrng.pixel_key(jrng.base_key(9), 4097, 3), 2)
    tk = trng.bounce_key(trng.pixel_key(trng.base_key(9), 4097, 3), 2)
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(jk)),
                                  np.asarray(tk, np.uint32))
    want = np.asarray(jrng.uniforms(jk, n, shape))
    got = trng.uniforms(tk, n, shape, "cpu").numpy()
    assert got.shape == want.shape == shape + (n,)
    np.testing.assert_array_equal(got, want)
    pix = np.arange(0, 70000, 997, dtype=np.int32)
    tkeys = trng.pixel_key(trng.base_key(9), torch.from_numpy(pix), 5)
    for i in (0, 17, len(pix) - 1):
        jki = jrng.pixel_key(jrng.base_key(9), int(pix[i]), 5)
        np.testing.assert_array_equal(
            np.asarray(jax.random.key_data(jki)),
            np.asarray([int(tkeys[0][i]), int(tkeys[1][i])], np.uint32))


# --- the dispatch, the counter and the fused path ---------------------------

M32 = 0xFFFFFFFF
# keys as the renderer derives them, and keys whose words have the top bit
TOP_KEYS = [(0x80000000, 0xFFFFFFFF), (0xDEADBEEF, 0x9E3779B9),
            (0xFFFFFFFF, 0x80000001)]
FUSED_KEYS = [trng.fold_in(trng.base_key(2023), 7), *TOP_KEYS]


def _np_threefry(k0, k1, x0, x1):
    """threefry2x32 in numpy uint32 (wrapping) arithmetic, as the kernel
    computes it."""
    k0, k1, x0, x1 = (np.asarray(v, np.uint32) for v in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0, x1 = x0 + ks[0], x1 + ks[1]
        for i in range(5):
            for r in ((13, 15, 26, 6), (17, 29, 16, 24))[i % 2]:
                x0 = x0 + x1
                x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _np_unit(bits):
    return ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1.0)


def _read(t, count, stride):
    """What the kernel reads: `count` int64 words from t's first element
    at `stride`, truncated to uint32."""
    assert t.dtype == torch.int64
    return torch.as_strided(t, (count,), (stride,),
                            t.storage_offset()).numpy().astype(np.uint32)


def emulate_launch(mode, key, out, out1=None, *, ids=None, sub=None,
                   data=0, rows=1, n=0):
    """csrc/threefry.cu's kernel in numpy, taking `rng._run`'s
    arguments and holding them to the kernel's contract: contiguous
    outputs, int64 inputs, flat contiguous key tensors."""
    k0, k1 = key
    per_key = isinstance(k0, torch.Tensor)
    if per_key:
        assert k0.is_contiguous() and k1.is_contiguous() and k0.ndim == 1
        k0, k1 = _read(k0, k0.numel(), 1), _read(k1, k1.numel(), 1)
    else:
        k0, k1 = np.uint32(k0 & M32), np.uint32(k1 & M32)
    assert out.is_contiguous() and (out1 is None or out1.is_contiguous())
    if mode == trng._LANE:
        assert not per_key and out.dtype == torch.float32
        assert out.shape == (rows, n)
        half = (n + 1) // 2
        lane = _read(ids, rows, ids.stride(0))[:, None]
        x1 = np.arange(half, dtype=np.uint32)[None, :]
        if sub is not None:
            with np.errstate(over="ignore"):
                x1 = x1 + _read(sub, rows, sub.stride(0))[:, None] * \
                    np.uint32(256)
        y0, y1 = _np_threefry(k0, k1, np.broadcast_to(lane, (rows, half)),
                              np.broadcast_to(x1, (rows, half)))
        bits = np.stack([y0, y1], -1).reshape(rows, 2 * half)[:, :n]
        out.copy_(torch.from_numpy(_np_unit(bits)))
    elif mode == trng._UNIFORM:
        assert out.dtype == torch.float32 and out.numel() == rows * n
        if per_key:
            assert k0.shape == (rows,)
            k0, k1 = k0[:, None], k1[:, None]
        j = np.arange(n, dtype=np.uint32)[None, :]
        y0, y1 = _np_threefry(k0, k1, np.zeros_like(j), j)
        out.view(rows, n).copy_(torch.from_numpy(_np_unit(y0 ^ y1)))
    else:
        assert out.dtype == out1.dtype == torch.int64
        assert out.numel() == n and out1.shape == out.shape
        x1 = _read(ids, n, ids.stride(0)) if ids is not None \
            else np.full(n, data & M32, np.uint32)
        if per_key:
            assert k0.shape == (n,)
        y0, y1 = _np_threefry(k0, k1, np.zeros(n, np.uint32), x1)
        out.view(-1).copy_(torch.from_numpy(y0.astype(np.int64)))
        out1.view(-1).copy_(torch.from_numpy(y1.astype(np.int64)))


@pytest.fixture
def fused_on_cpu(monkeypatch):
    """CPU tensors take the fused path, its launch run by emulate_launch;
    yields the list of launch modes."""
    modes = []

    def run(mode, *args, **kw):
        modes.append(mode)
        emulate_launch(mode, *args, **kw)

    monkeypatch.setattr(trng, "_on_card", lambda dev: True)
    monkeypatch.setattr(trng, "_run", run)
    trng.zero_launch_counts()
    yield modes
    trng.zero_launch_counts()


def _no_kernel(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel was reached from CPU tensors")

    monkeypatch.setattr(trng, "_run", refuse)
    monkeypatch.setattr(trng, "_library", refuse)


def _draws(dev="cpu"):
    """One tensor draw of each form: lanes, uniform with integer and with
    tensor keys, fold_in with tensor data and with tensor keys."""
    key = trng.fold_in(trng.base_key(11), 7)
    lanes = torch.arange(100, device=dev)
    keys = trng.fold_in(key, torch.arange(6, device=dev))
    return [trng.lane_uniforms(key, lanes, 3, sub_ids=lanes % 7),
            trng.uniform(key, (5, 3), dev),
            trng.uniform(keys, (2, 9)),
            keys,
            trng.fold_in(keys, 5)]


def test_cpu_tensors_take_the_eager_path(monkeypatch):
    """On CPU tensors every draw is the eager path: the kernel is never
    loaded or launched, and the draws are the eager functions' own."""
    _no_kernel(monkeypatch)
    key = trng.fold_in(trng.base_key(11), 7)
    lanes = torch.arange(100)
    got = _draws()
    assert torch.equal(got[0], trng._lane_uniforms_eager(key, lanes, 3,
                                                         lanes % 7))
    assert torch.equal(got[1], trng._uniform_eager(key, (5, 3), 15, "cpu"))


def test_rng_calls_counts_each_tensor_draw_once():
    """While recording, each tensor draw adds one to `rng_calls` under its
    path; integer key derivation is no draw and counts nothing."""
    with trace_scope.recording():
        trng.stream_key(trng.fold_in(trng.base_key(3), 4), 1)
        _draws()
        first = trace_scope.counters()["rng_calls"]
        _draws()
    assert first == {"eager": 5}
    assert trace_scope.counters()["rng_calls"] == {"eager": 10}


def test_rng_calls_off_records_nothing(monkeypatch):
    """Outside a recording a draw touches no counter: the last recording's
    counters stay as they were and `count` returns at its first check."""
    with trace_scope.recording():
        trng.lane_uniforms((1, 2), torch.arange(4), 2)
    before = trace_scope.counters()
    monkeypatch.setattr(trace_scope, "_counts", None)   # any use raises
    _draws()
    monkeypatch.undo()
    assert before == {"rng_calls": {"eager": 1}}
    assert trace_scope.counters() == before


def test_fused_draws_count_as_fused(fused_on_cpu):
    """Each fused draw is one launch, counted by its entry point's
    `.launches` and, while recording, under `rng_calls["fused"]`."""
    with trace_scope.recording():
        _draws()
    assert trace_scope.counters()["rng_calls"] == {"fused": 5}
    assert fused_on_cpu == [trng._FOLD, trng._LANE, trng._UNIFORM,
                            trng._UNIFORM, trng._FOLD]
    assert (trng.lane_uniforms.launches, trng.uniform.launches,
            trng.fold_in.launches) == (1, 2, 2)
    _draws()                           # outside a recording: launches only
    assert trace_scope.counters()["rng_calls"] == {"fused": 5}
    assert trng.uniform.launches == 4


def test_empty_fused_draw_launches_nothing(fused_on_cpu):
    """An empty draw returns its empty result and launches nothing."""
    key = trng.fold_in(trng.base_key(2), 1)
    with trace_scope.recording():
        a = trng.lane_uniforms(key, torch.arange(0), 4)
        b = trng.uniform(key, (3, 0), "cpu")
        c = trng.fold_in(key, torch.zeros((2, 0), dtype=torch.int64))
    assert a.shape == (0, 4) and b.shape == (3, 0)
    assert c[0].shape == c[1].shape == (2, 0)
    assert fused_on_cpu == []
    assert "rng_calls" not in trace_scope.counters()
    assert trng.lane_uniforms.launches == trng.fold_in.launches == 0


def test_fused_draws_import_no_module():
    """The fused path's first draws, of every form, import no module (the
    card's first solve once paid seconds for sympy, which
    `torch.broadcast_shapes` imports); run in a fresh process."""
    code = """if True:
        import sys
        import torch
        from tpu_pathtracer_torch.core import rng
        rng._on_card = lambda device: True
        rng._run = lambda *args, **kw: None
        key = rng.fold_in(rng.base_key(3), 4)
        before = set(sys.modules)
        keys = rng.fold_in(key, torch.arange(6))
        rng.fold_in(keys, 5)
        rng.fold_in(keys, torch.arange(6).reshape(2, 3, 1)[0])
        rng.uniform(keys, (2, 3))
        rng.uniform(key, (4,), "cpu")
        rng.lane_uniforms(key, torch.arange(5), 3, sub_ids=torch.arange(5))
        print(sorted(set(sys.modules) - before))
    """
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.stdout.strip() == "[]", out.stdout


def test_emulated_kernel_is_the_eager_threefry():
    """The numpy model of the kernel agrees with `threefry2x32` (so the
    fused-path tests below test the wrapper, not the model)."""
    g = np.random.default_rng(1)
    x0 = g.integers(0, 2**32, 1000, dtype=np.uint64)
    x1 = g.integers(0, 2**32, 1000, dtype=np.uint64)
    for k0, k1 in FUSED_KEYS:
        y0, y1 = _np_threefry(k0, k1, x0.astype(np.uint32),
                              x1.astype(np.uint32))
        e0, e1 = trng.threefry2x32((k0, k1),
                                   torch.from_numpy(x0.astype(np.int64)),
                                   torch.from_numpy(x1.astype(np.int64)))
        np.testing.assert_array_equal(y0, e0.numpy().astype(np.uint32))
        np.testing.assert_array_equal(y1, e1.numpy().astype(np.uint32))


def _lane_cases(g, b=257):
    """(lane ids, sub ids) forms: int64 and int32, ids at and above 2**31
    and negative, a strided column, sub ids up to 511 and one broadcast."""
    lanes = torch.from_numpy(g.integers(-2**31, 2**33, b))
    lanes[:3] = torch.tensor([2**31 - 1, 2**31, 2**32 - 1])
    sub = torch.from_numpy(g.integers(0, 512, b))
    wide = torch.stack([lanes, lanes + 1, lanes + 2], 1)   # (b, 3)
    return [(lanes, None), (lanes, sub), (lanes.to(torch.int32), sub),
            (wide[:, 1], sub.to(torch.int32)), (lanes, sub[:1]),
            (lanes[:0], sub[:0])]


@pytest.mark.parametrize("n", [1, 2, 3, 8, 27, 512])
def test_fused_lane_uniforms_match_eager(fused_on_cpu, n):
    g = np.random.default_rng(n)
    for key in FUSED_KEYS:
        for lanes, sub in _lane_cases(g):
            got = trng.lane_uniforms(key, lanes, n, sub_ids=sub)
            want = trng._lane_uniforms_eager(key, lanes, n, sub)
            assert got.shape == want.shape == (lanes.shape[0], n)
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32))
    assert set(fused_on_cpu) == {trng._LANE}


@pytest.mark.parametrize("shape", [(7,), (4, 1, 33), (3, 4, 8), (2, 0), ()])
@pytest.mark.parametrize("lead", [None, (5,), (2, 3)])
def test_fused_uniform_matches_eager(fused_on_cpu, shape, lead):
    for key in FUSED_KEYS:
        if lead is not None:
            data = torch.arange(np.prod(lead)).reshape(lead) * 977
            key = trng.fold_in(key, data)
        got = trng.uniform(key, shape, "cpu")
        n = int(np.prod(shape))
        want = trng._uniform_eager(key, shape, n, "cpu")
        assert got.shape == want.shape == (lead or ()) + shape
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("form", ["data", "key", "both", "scalar_data"])
def test_fused_fold_in_matches_eager(fused_on_cpu, form):
    g = np.random.default_rng(3)
    data = torch.from_numpy(g.integers(-2**31, 2**32, (4, 6)))
    for key in FUSED_KEYS:
        if form in ("key", "both"):
            key = trng.fold_in(key, torch.arange(24).reshape(4, 6))
        d = {"data": data, "key": 12345, "both": data,
             "scalar_data": torch.tensor(2**31 + 5)}[form]
        got = trng.fold_in(key, d)
        dt = d.to(torch.int64) if isinstance(d, torch.Tensor) else d
        want = trng.threefry2x32(key, 0, dt & M32)
        for a, b in zip(got, want):
            assert a.dtype == torch.int64 and a.shape == b.shape
            assert torch.equal(a, b)


def test_fused_path_brings_other_forms_to_the_kernel(fused_on_cpu):
    """Key tensors of another dtype, fold_in data that broadcasts against
    its keys, and one sub id for all lanes are brought to the kernel's
    form and drawn there, as the eager path draws them."""
    key = trng.fold_in(trng.base_key(5), torch.arange(4))
    data = torch.arange(8, dtype=torch.int32).reshape(2, 1, 4)
    got = trng.fold_in(key, data)
    want = trng.threefry2x32(key, 0, data.to(torch.int64))
    assert all(a.shape == b.shape == (2, 1, 4) and torch.equal(a, b)
               for a, b in zip(got, want))
    k32 = (key[0].to(torch.int32), key[1])
    got = trng.uniform(k32, (3,))
    want = trng._uniform_eager((k32[0].to(torch.int64), key[1]), (3,), 3,
                               "cpu")
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    lanes = torch.arange(5)
    for sub in (torch.tensor([9]), torch.tensor(9)):
        got = trng.lane_uniforms((3, 4), lanes, 6, sub_ids=sub)
        want = trng._lane_uniforms_eager((3, 4), lanes, 6,
                                         torch.full((5,), 9))
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert fused_on_cpu == [trng._FOLD] * 2 + [trng._UNIFORM] + \
        [trng._LANE] * 2


@pytest.mark.parametrize("form", ["tensor_key", "lanes_2d", "sub_shape",
                                  "devices"])
def test_fused_path_refuses_forms_it_cannot_draw(fused_on_cpu, form):
    """On the card a draw the kernel cannot take raises: there is no
    fallback to the eager path."""
    key = trng.fold_in(trng.base_key(5), 3)
    lanes = torch.arange(4)
    tensor_key = trng.fold_in(key, lanes)
    del fused_on_cpu[:]
    call = {
        "tensor_key": lambda: trng.lane_uniforms(tensor_key, lanes, 2),
        "lanes_2d": lambda: trng.lane_uniforms(key, lanes[None], 2),
        "sub_shape": lambda: trng.lane_uniforms(key, lanes, 2,
                                                sub_ids=torch.arange(3)),
        "devices": lambda: trng.lane_uniforms(
            key, lanes, 2, sub_ids=torch.zeros(4, device="meta")),
    }[form]
    with trace_scope.recording():
        with pytest.raises((ValueError, RuntimeError)):
            call()
    assert "rng_calls" not in trace_scope.counters()
    assert fused_on_cpu == []


def test_sub_ids_limit_holds_on_the_fused_path(fused_on_cpu):
    with pytest.raises(ValueError):
        trng.lane_uniforms((0, 1), torch.arange(4), 513,
                           sub_ids=torch.zeros(4, dtype=torch.int64))


# --- on the card: the kernel against the eager path -------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("the threefry kernel needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("n", [1, 2, 3, 8, 27, 512])
def test_card_lane_uniforms_bitwise(n):
    dev = _card()
    g = np.random.default_rng(100 + n)
    for key in FUSED_KEYS:
        for lanes, sub in _lane_cases(g, b=65_536 if n <= 8 else 4099):
            lanes = lanes.to(dev)
            sub = None if sub is None else sub.to(dev)
            got = trng._lane_uniforms_fused(key, lanes, n, sub)
            want = trng._lane_uniforms_eager(key, lanes, n, sub)
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), (key, n)


@pytest.mark.card
@pytest.mark.parametrize("shape", [(7,), (4, 1, 33), (16, 4, 64, 1024),
                                   (3, 0)])
@pytest.mark.parametrize("lead", [None, (64,), (4, 16)])
def test_card_uniform_bitwise(shape, lead):
    dev = _card()
    n = int(np.prod(shape))
    for key in FUSED_KEYS:
        if lead is not None:
            key = trng.fold_in(key, torch.arange(
                int(np.prod(lead)), device=dev).reshape(lead) * 7919)
        got = trng._uniform_fused(key, shape, n, dev)
        want = trng._uniform_eager(key, shape, n, dev)
        assert got.shape == want.shape
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.card
@pytest.mark.parametrize("form", ["data", "key", "both"])
def test_card_fold_in_bitwise(form):
    dev = _card()
    g = np.random.default_rng(7)
    data = torch.from_numpy(g.integers(-2**31, 2**32, (64, 33))).to(dev)
    for key in FUSED_KEYS:
        if form != "data":
            key = trng.fold_in(key, torch.from_numpy(
                g.integers(0, 2**32, (64, 33))).to(dev))
        d = 2**32 - 3 if form == "key" else data
        got = trng._fold_in_fused(key, d)
        want = trng.threefry2x32(key, 0, d & M32)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.card
def test_card_draws_take_the_fused_path():
    """On the card every tensor draw of `_draws` launches the kernel, and
    each equals the CPU's eager draw."""
    dev = _card()
    trng.zero_launch_counts()
    with trace_scope.recording():
        got = _draws(dev)
    assert trace_scope.counters()["rng_calls"] == {"fused": 5}
    assert (trng.lane_uniforms.launches, trng.uniform.launches,
            trng.fold_in.launches) == (1, 2, 2)
    for a, b in zip(got, _draws()):
        if isinstance(a, tuple):
            assert all(torch.equal(x.cpu(), y) for x, y in zip(a, b))
        else:
            assert torch.equal(a.cpu(), b)
