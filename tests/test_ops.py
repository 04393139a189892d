"""Packed-descriptor Hamming matching (frontend/matcher.py) against numpy
bit counts."""

import jax.numpy as jnp
import numpy as np
import pytest

from okvis2x_tpu.frontend import matcher
from okvis2x_tpu.frontend.descriptor import DESC_BITS

pytestmark = pytest.mark.smoke

RNG = np.random.default_rng(21)


def pack(bits):  # (N, 384) -> (N, 12) uint32
    b = bits.reshape(bits.shape[0], 12, 32).astype(np.uint32)
    return (b << np.arange(32, dtype=np.uint32)[None, None, :]).sum(-1).astype(
        np.uint32
    )


def test_packed_hamming_matches_reference():
    bits_q = RNG.integers(0, 2, (256, DESC_BITS))
    bits_d = RNG.integers(0, 2, (512, DESC_BITS))
    D = np.asarray(
        matcher.hamming_matrix_packed(
            jnp.asarray(pack(bits_q)), jnp.asarray(pack(bits_d))
        )
    )
    D_ref = (bits_q[:, None, :] != bits_d[None, :, :]).sum(-1)
    np.testing.assert_array_equal(D, D_ref)


def test_best_matches_packed():
    bits = RNG.integers(0, 2, (256, DESC_BITS))
    bits_d = bits.copy()
    for i in range(256):
        idx = RNG.integers(0, DESC_BITS, 7)
        bits_d[i, idx] ^= 1
    valid = np.ones(256, bool)
    m = matcher.match_packed_mutual(
        jnp.asarray(pack(bits)), jnp.asarray(valid),
        jnp.asarray(pack(bits_d)), jnp.asarray(valid),
    )
    assert (np.asarray(m.idx_b) == np.arange(256)).all()
    assert np.asarray(m.dist).max() <= 7
    assert bool(np.asarray(m.valid).all())
