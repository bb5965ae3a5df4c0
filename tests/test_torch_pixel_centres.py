"""Divisions by a constant, rounded as chord_tpu's jitted frames round them.

XLA compiles `x / c` for a constant c as `x * (1/c)`, the constant's f32
reciprocal, so chord_tpu's jitted frames (and the goldens rendered from
them) see pixel-centre NDCs `(arange(n) + 0.5) / n * 2 - 1` that differ
from an exact division in the last bit for most n that are not powers of
two (224 of 1,280 columns, 1,053 of 1,920). PyTorch's CUDA division by a
Python number multiplies by the reciprocal too; its CPU division is exact.
The port's CPU path divided exactly: the g-buffer positions it unprojects
from those NDCs moved by an ulp, which flipped PCSS tests at bench size
(the pipelined split's frame 1: worst 16x16 window 0.854 against
chord_tpu's frame, `tests/bench_parity.py split`). At 128x64 the
divisors are powers of two, where both roundings agree, so the tests here
use the bench sizes and the golden size (160x96). (The NDC's `* 2 - 1`
that follows is exact without FMA, as the goldens are compiled; XLA's
default CPU build fuses it with the constant folded, the FMA contraction
the goldens leave out.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chord_tpu_torch.ops._util import centres, recip

SIZES = (64, 96, 104, 160, 200, 720, 1080, 1280, 1920, 2160, 3840)


@pytest.mark.parametrize("n", SIZES)
def test_centres_are_chord_tpus_jitted_division(n):
    """chord_tpu's pixel and LUT cell centres (shading.py:526, meshlet_frame
    .py:207, atmosphere.py:110), jitted, bit for bit."""
    ref = np.asarray(jax.jit(
        lambda: (jnp.arange(n, dtype=jnp.float32) + 0.5) / n)())
    got = centres(n, "cpu").numpy()
    np.testing.assert_array_equal(got, ref)
    if n & (n - 1):     # not a power of two: the exact quotient differs
        exact = (torch.arange(n, dtype=torch.float32) + 0.5) / n
        assert (exact.numpy() != ref).any()


@pytest.mark.parametrize("c", [3.0, 7.0, 126.0, 255.0, 1e-3, 1280.0])
def test_recip_is_xlas_constant_division(c):
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v: v / c)(x))
    np.testing.assert_array_equal(torch.from_numpy(x).mul(recip(c)).numpy(),
                                  ref)

