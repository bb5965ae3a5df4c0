"""Row gather (K3's plain version) against chord_tpu's Pallas bank-sweep
kernel in interpret mode. Tolerance: bit-exact — values move as int32 bit
patterns end to end. Includes negative slots (clamp to row 0), slots past
the table (zero rows), f32 and integer columns, and a table spanning
several 128-row banks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chord_tpu.ops import row_gather as jrg

from chord_tpu_torch.ops import row_gather


@pytest.mark.parametrize("n,h,w", [(300, 24, 200), (2560, 16, 130)])
def test_gather_rows_bit_exact(n, h, w):
    rng = np.random.default_rng(n)
    fcols = [rng.standard_normal(n).astype(np.float32) for _ in range(9)]
    icols = [rng.integers(-5, 1 << 20, n).astype(np.int32) for _ in range(4)]
    slot = rng.integers(-3, n + 40, (h, w)).astype(np.int32)
    slot[0, :8] = [-1, -7, 0, n - 1, n, n + 1, 127, 128]
    jt = jrg.pack_table([jnp.asarray(c) for c in fcols + icols])
    ref = np.asarray(jrg.gather_rows(jt, jnp.asarray(slot), interpret=True))
    tt = row_gather.pack_table([torch.from_numpy(c) for c in fcols + icols])
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    got = row_gather.gather_rows(tt, torch.from_numpy(slot))
    assert got.dtype == torch.int32 and got.shape == (16, h, w)
    np.testing.assert_array_equal(got.numpy(), ref)
    # spot-check the semantics directly
    np.testing.assert_array_equal(got[:, 0, 0].numpy(), tt[:, 0].numpy())
    assert (got[:, 0, 4].numpy() == 0).all()
