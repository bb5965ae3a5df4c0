"""The port's fusion barrier (kernel K9's plain version) against chord_tpu's.

chord_tpu's fusion_barrier runs its Pallas copy in interpret mode on the
CPU (it picks interpret mode itself there). Tolerance: none, the copy is
held bit for bit (compared as bytes, so NaN payloads and signed zeros
count), and its output must not alias its input. chord_tpu's interpret
mode cannot take a zero-element array (a division by the block size), so
the empty case checks the port alone: an empty tensor of the same shape
and dtype.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chord_tpu.ops.fusion_barrier import fusion_barrier as jax_barrier

from chord_tpu_torch.ops import fusion_barrier as fb

DTYPES = [np.float32, np.int32, np.uint8, np.bool_]
SHAPES = [(135, 240), (7,), (3, 5, 2)]


def _random(rng, dtype, shape):
    if dtype == np.float32:
        x = rng.normal(size=shape).astype(np.float32)
        flat = x.reshape(-1)
        flat[: min(3, flat.size)] = [np.nan, -0.0, np.inf][: min(3, flat.size)]
        return x
    if dtype == np.bool_:
        return rng.uniform(size=shape) < 0.5
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, endpoint=True,
                        dtype=np.int64).astype(dtype)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_fusion_barrier_matches(dtype, shape):
    x = _random(np.random.default_rng(len(shape)), dtype, shape)
    ref = np.asarray(jax_barrier(jnp.asarray(x)))
    xt = torch.from_numpy(x.copy())
    got = fb.fusion_barrier(xt)
    assert got.shape == xt.shape and got.dtype == xt.dtype
    assert got.numpy().tobytes() == ref.tobytes() == x.tobytes()
    assert got.data_ptr() != xt.data_ptr()
    got.view(torch.uint8).zero_()
    assert xt.numpy().tobytes() == x.tobytes()     # no shared storage


@pytest.mark.parametrize("shape", [(0,), (0, 4)])
def test_fusion_barrier_empty(shape):
    x = torch.empty(shape, dtype=torch.float32)
    got = fb.fusion_barrier(x)
    assert got.shape == x.shape and got.dtype == x.dtype
    assert got is not x
