"""The port's f32 sin and cos are chord_tpu's: `ops/_util.sincosf`.

chord_tpu's XLA computes an f32 sin or cos on the CPU by calling the C
library's sinf and cosf (glibc's: a short f64 algorithm with its own
tables); PyTorch's sin, numpy's f32 sin and the f64 value rounded to f32
each differ from it on 1-14% of inputs, which moved the port's ray
directions (RTAO's fan, the GGX half-vector) by ulps. `sincosf` transcribes
glibc's sinf / cosf in f64 torch ops (on the card the sincos kernel, held
to it in chip_smoke.py). Here it is held bit for bit to ctypes' libm and
to chord_tpu's jitted jnp.sin / jnp.cos, on seeded inputs of every range
and on the edges of the algorithm's branches; `dot3` / `norm3` to their
ordered f32 sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chord_tpu_torch.ops import _util
from rt_cases import libm_sincosf

F32 = np.float32


def _bits(x):
    return np.asarray(x, F32).view(np.int32)


def _edges():
    """The branches' edges: below and above 2^-12, 0.75 (the small
    branch's top 12 bits) and 120, around multiples of pi/2 up to 200, the
    largest floats and the denormals; both signs."""
    f = F32
    pts = [0.0, 2.0 ** -12, 0.75, 0.7853982, 120.0, 2.0 ** 20, 3.4028235e38,
           1e-45, 1.1754944e-38, 1e-30]
    pts += [k * np.pi / 2 for k in range(1, 128)]
    out = []
    for p in pts:
        x = f(p)
        lo = hi = x
        for _ in range(3):
            with np.errstate(over="ignore"):
                lo, hi = np.nextafter(lo, f(0)), np.nextafter(hi, f(np.inf))
            out += [lo, hi]
        out.append(x)
    with np.errstate(over="ignore"):
        out = np.array(out, F32)
    out = out[np.isfinite(out)]
    return np.concatenate([out, -out])


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(22)
    k = 1 << 16
    x = np.concatenate([
        rng.uniform(-30, 30, k), rng.uniform(-1, 1, k),
        rng.uniform(-120, 120, k),
        10 ** rng.uniform(-40, 38.5, k) * rng.choice([-1.0, 1.0], k),
        _edges()]).astype(F32)
    return x, libm_sincosf(x)


def test_sincosf_equals_libm(inputs):
    x, (want_s, want_c) = inputs
    s, c = _util.sincosf(torch.from_numpy(x))
    assert s.dtype == c.dtype == torch.float32
    assert np.array_equal(_bits(s.numpy()), _bits(want_s))
    assert np.array_equal(_bits(c.numpy()), _bits(want_c))


def test_sincosf_equals_xlas_jitted_sin_and_cos(inputs):
    x = inputs[0]
    s, c = _util.sincosf(torch.from_numpy(x))
    assert np.array_equal(_bits(s.numpy()),
                          _bits(np.asarray(jax.jit(jnp.sin)(x))))
    assert np.array_equal(_bits(c.numpy()),
                          _bits(np.asarray(jax.jit(jnp.cos)(x))))


def test_sincosf_of_a_non_finite_input_is_nan():
    x = torch.tensor([np.inf, -np.inf, np.nan], dtype=torch.float32)
    s, c = _util.sincosf(x)
    assert torch.isnan(s).all() and torch.isnan(c).all()


def test_sincosf_takes_only_f32():
    with pytest.raises(ValueError, match="float32"):
        _util.sincosf(torch.zeros(3, dtype=torch.float64))


def test_sincosf_keeps_the_shape_and_is_the_plain_version_on_the_cpu():
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        -7, 7, (5, 4, 1)).astype(F32))
    s, c = _util.sincosf(x)
    ps, pc = _util.sincosf_plain(x)
    assert s.shape == c.shape == x.shape
    assert torch.equal(s, ps) and torch.equal(c, pc)


def test_dot3_and_norm3_sum_in_order():
    rng = np.random.default_rng(6)
    a = rng.standard_normal((4000, 3)).astype(F32) * F32(7)
    b = rng.standard_normal((4000, 3)).astype(F32)
    want = (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]) + a[:, 2] * b[:, 2]
    got = _util.dot3(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert np.array_equal(got, want)
    n = _util.norm3(torch.from_numpy(a), keepdim=True).numpy()
    sq = (a[:, 0] * a[:, 0] + a[:, 1] * a[:, 1]) + a[:, 2] * a[:, 2]
    assert n.shape == (4000, 1)
    assert np.array_equal(n[:, 0], np.sqrt(sq))
