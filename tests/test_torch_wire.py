"""Port parity: the wire codecs (``stochastic_gradient_push_torch.parallel.
wire``) encode, decode and decode-add bit-equal to the JAX package's, on
ragged, zero and non-multiple-of-block payloads (exact: ``array_equal``
on the int8 codes, the f32 scales, the bf16 bits and the decoded
values).

The reference's codecs run inside its compiled gossip round, so they are
compared here as compiled (``jax.jit``): XLA turns the int8 encode's
division by 127 into a multiplication by the float32 reciprocal, and
fuses a decode and the add that follows into one multiply-add.  The
port's codecs take rank-stacked leaves; one payload is ``x[None]``.
"""

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.parallel import wire as tw


def _payloads():
    r = np.random.default_rng(0)
    return {
        "ragged": r.standard_normal(1000).astype(np.float32),
        "zeros": np.zeros((7, 9), np.float32),
        "one_block_short": r.standard_normal(63).astype(np.float32) * 1e3,
        "matrix": r.standard_normal((33, 17)).astype(np.float32),
        "tiny": (r.standard_normal(130) * 1e-30).astype(np.float32),
        "mixed_zero_blocks": np.concatenate(
            [np.zeros(64, np.float32),
             r.standard_normal(70).astype(np.float32)]),
        "halfway": (np.arange(-300, 300, dtype=np.float32) + 0.5) / 127.0,
    }


def _codecs(name):
    from stochastic_gradient_push_tpu.parallel import wire as rw

    if name == "bf16":
        return rw.BF16, tw.BF16
    block = int(name.split("_")[1])
    return rw.Int8Codec(block), tw.Int8Codec(block)


@pytest.mark.parametrize("codec", ["bf16", "int8_64", "int8_7", "int8_1"])
@pytest.mark.parametrize("payload", sorted(_payloads()))
def test_encode_decode_bit_equal(codec, payload):
    import jax
    import jax.numpy as jnp

    x = _payloads()[payload]
    ref, port = _codecs(codec)
    want_parts = jax.jit(ref.encode)(jnp.asarray(x))
    got_parts = port.encode(torch.from_numpy(x)[None])
    assert len(got_parts) == len(want_parts)
    for g, w in zip(got_parts, want_parts):
        w = np.asarray(w)
        g = g[0]
        if g.dtype == torch.bfloat16:
            g, w = g.view(torch.int16).numpy(), w.view(np.int16)
        else:
            g = g.numpy()
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    like = jnp.asarray(x)
    want = np.asarray(jax.jit(ref.decode)(want_parts, like))
    got = port.decode(got_parts, torch.from_numpy(x)[None])[0].numpy()
    np.testing.assert_array_equal(got, want)
    acc = np.random.default_rng(5).standard_normal(x.shape).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda w, a: a + ref.decode(w, a))(
        want_parts, jnp.asarray(acc)))
    got = port.decode_add(got_parts, torch.from_numpy(acc)[None])[0]
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_blocks_each_rank_on_its_own():
    r = np.random.default_rng(1)
    x = r.standard_normal((3, 5, 13)).astype(np.float32)
    x[1] *= 100.0
    codec = tw.Int8Codec(8)
    stacked = codec.decode(codec.encode(torch.from_numpy(x)),
                           torch.from_numpy(x))
    for i in range(3):
        one = torch.from_numpy(x[i])[None]
        np.testing.assert_array_equal(
            stacked[i].numpy(), codec.decode(codec.encode(one), one)[0])


def test_get_codec_resolves_flag_values():
    assert tw.get_codec(None) is None
    assert tw.get_codec("f32") is tw.F32 and not tw.F32.lossy
    assert tw.get_codec("bf16") is tw.BF16
    assert tw.get_codec("int8", 32).block == 32
    with pytest.raises(ValueError, match="wire_dtype"):
        tw.get_codec("fp8")
    with pytest.raises(ValueError, match="wire_block"):
        tw.Int8Codec(0)
