"""The port's copy of the ChaCha20 sampler draws the JAX package's stream,
word for word: the port generates the keystream word-major and reads ahead,
which must change no draw.  Pure numpy on both sides (under a second)."""

import numpy as np
import pytest

from reference_seal_backend_tpu.schemes import csprng as jrng
from reference_seal_backend_tpu_torch.schemes import csprng as trng

AHEAD = trng._READ_AHEAD_BLOCKS * 16  # words generated per pass, at least


@pytest.mark.parametrize("counter0", [0, 7, (1 << 32) - 2])
@pytest.mark.parametrize("n_blocks", [1, 5, 64])
def test_block_function_equal(counter0, n_blocks):
    a, b = trng.ChaChaRng(b"k" * 32, stream=9), jrng.ChaChaRng(b"k" * 32, stream=9)
    got = trng.chacha_blocks(a._key_words, a._nonce, counter0, n_blocks)
    want = jrng.chacha_blocks(b._key_words, b._nonce, counter0, n_blocks)
    assert got.shape == (n_blocks, 16) and got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "sizes",
    [(1, 2, 3), (1024,) * 5, (AHEAD - 1, 1, 1, 16), (AHEAD + 5, 3, 2 * AHEAD),
     (16384, 7, 16384, 100000)],
    ids=["tiny", "n1024", "at_the_boundary", "over_the_boundary", "n16384"],
)
@pytest.mark.parametrize("seed", [1234, (3, 4), b"bytes"])
def test_stream_equal_across_draw_sizes(seed, sizes):
    a, b = trng.ChaChaRng(seed, stream=0xE4C), jrng.ChaChaRng(seed, stream=0xE4C)
    for n in sizes:
        np.testing.assert_array_equal(a.u32(n), b.u32(n))
    np.testing.assert_array_equal(a.u64(5), b.u64(5))
    np.testing.assert_array_equal(
        a.integers(0, 1073479681, size=(3, 50)), b.integers(0, 1073479681, size=(3, 50))
    )
    np.testing.assert_array_equal(a.integers(-1, 2, size=77), b.integers(-1, 2, size=77))
    np.testing.assert_array_equal(a.normal(0, 3.2, size=33), b.normal(0, 3.2, size=33))
    assert a.integers(0, 10) == b.integers(0, 10)
    assert a._counter >= b._counter  # the port has read ahead, never behind


def test_streams_are_separate_and_errors_raise():
    a, b = trng.ChaChaRng(1, stream=0), trng.ChaChaRng(1, stream=1)
    assert (a.u32(16) != b.u32(16)).any()
    with pytest.raises(ValueError):
        a.integers(5, 5)
    with pytest.raises(NotImplementedError):
        a.integers(0, (1 << 32) + 1)
