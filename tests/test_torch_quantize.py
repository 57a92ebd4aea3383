"""Port vs JAX: the two-plane KV quantization (``ops/quantize.py``) and the
cache appends (``engine/kv_cache.py``).  The planes must match byte for
byte: the decode kernel scores raw packed bytes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatten_tpu.engine import kv_cache as jkv
from spatten_tpu.ops import quantize as jqz

from spatten_tpu_torch.engine import kv_cache as tkv
from spatten_tpu_torch.ops import quantize as tqz


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rand(shape, seed=0, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    x[..., 0, 0, :] = 0.0                 # an all-zero row: scale 1 path
    return x.astype(np.float32)


def assert_planes_equal(tq, jq):
    for name in ("full", "msb", "scale", "lsb2"):
        a, b = getattr(tq, name), getattr(jq, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)


@pytest.mark.parametrize("tokens", [64, 4096])
def test_quantize_planes_byte_exact(tokens):
    x = rand((2, 3, tokens, 8), seed=tokens, scale=3.0)
    tq = tqz.quantize(torch.from_numpy(x), with_msb=True, with_lsb2=True)
    jq = jqz.quantize(jnp.asarray(x), with_msb=True, with_lsb2=True)
    assert_planes_equal(tq, jq)
    for fn in ("dequantize_full", "dequantize_msb", "dequantize_6bit"):
        np.testing.assert_allclose(getattr(tqz, fn)(tq).numpy(),
                                   np.asarray(getattr(jqz, fn)(jq)),
                                   rtol=1e-6, atol=0)


def test_pack_unpack_roundtrip_matches_jax():
    q8 = np.random.default_rng(1).integers(-127, 128, (2, 2048, 16)
                                           ).astype(np.int8)
    for pack, unpack in (("pack_msb", "unpack_msb"),
                         ("pack_lsb2", "unpack_lsb2")):
        tp = getattr(tqz, pack)(torch.from_numpy(q8))
        jp = getattr(jqz, pack)(jnp.asarray(q8))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(getattr(tqz, unpack)(tp).numpy(),
                                      np.asarray(getattr(jqz, unpack)(jp)))
    assert tqz.pack_unit(4096) == jqz.pack_unit(4096) == 2048


def test_update_token_byte_exact():
    """Nibble read-modify-write at hi and lo halves of a unit, batched."""
    b, h, t, d = 3, 2, 64, 8
    x = rand((b, h, t, d), seed=2)
    new = np.random.default_rng(3).standard_normal((b, h, d)
                                                   ).astype(np.float32)
    index = np.array([0, 37, 63], np.int32)        # hi, lo, last lo
    jq = jqz.quantize(jnp.asarray(x), with_lsb2=True)
    tq = tqz.quantize(torch.from_numpy(x), with_lsb2=True)
    jout = jax.vmap(jqz.update_token)(jq, jnp.asarray(new),
                                      jnp.asarray(index))
    tout = tqz.update_token(tq, torch.from_numpy(new),
                            torch.from_numpy(index))
    assert tout is tq                                # in place
    assert_planes_equal(tout, jout)


def test_gather_tokens_exact():
    x = rand((2, 2, 64, 8), seed=4)
    idx = np.sort(np.random.default_rng(5).permutation(64)[:40]
                  .reshape(1, 1, 40).repeat(2, 0).repeat(2, 1), axis=-1)
    jq = jqz.gather_tokens(jqz.quantize(jnp.asarray(x)), jnp.asarray(idx))
    tq = tqz.gather_tokens(tqz.quantize(torch.from_numpy(x)),
                           torch.from_numpy(idx))
    assert_planes_equal(tq, jq)


@pytest.mark.parametrize("s", [1, 5])
def test_append_tokens_exact(s):
    """Single-token (nibble RMW) and chunk (wholesale repack) appends."""
    b, hkv, cap, d = 2, 2, 64, 8
    lengths = np.array([10, 31], np.int32)
    kn = rand((b, hkv, s, d), seed=6)
    vn = rand((b, hkv, s, d), seed=7)
    jc = jkv.init_layer_cache(b, hkv, cap, d)
    tc = tkv.init_stacked_cache(1, b, hkv, cap, d, device="cpu").layer(0)
    jc = jkv.append_tokens(jc, jnp.asarray(kn), jnp.asarray(vn),
                           jnp.asarray(lengths))
    tkv.append_tokens(tc, torch.from_numpy(kn), torch.from_numpy(vn),
                      torch.from_numpy(lengths))
    assert_planes_equal(tc.k, jc.k)
    assert_planes_equal(tc.v, jc.v)
