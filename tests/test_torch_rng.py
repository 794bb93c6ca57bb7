"""The port's counter-based RNG against the JAX package's: key derivation
and `lane_uniforms` bits are held bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.core import rng as jrng
from tpu_pathtracer_torch.core import rng as trng

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
