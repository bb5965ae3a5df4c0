"""Small tensor helpers shared by the ops."""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _cuda

_I32_MAX_F = 2147483520.0   # largest f32 below 2**31


def f2i(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 truncating toward zero and SATURATING at the int32
    range, as XLA's convert does (a plain .to(int32) of an out-of-range
    float is undefined on the CPU). NaN maps to 0."""
    x = torch.nan_to_num(x, nan=0.0)
    return torch.clamp(x, -2147483648.0, _I32_MAX_F).to(torch.int32)


def recip(c) -> float:
    """The f32 reciprocal of a constant divisor: chord_tpu's jitted code
    divides by a constant as XLA compiles it, a multiply by the constant's
    f32 reciprocal (PyTorch's CUDA division by a Python number does the
    same; its CPU division is exact), so the port writes such an `x / c`
    as `x * recip(c)` where rounding decides a later test."""
    return float(np.float32(1.0) / np.float32(c))


def centres(n: int, device) -> torch.Tensor:
    """(arange(n) + 0.5) / n, the n cell centres in [0, 1], rounded as
    chord_tpu's jitted code rounds them (recip)."""
    return (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * \
        recip(n)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The square root rounded to nearest, as XLA's and CUDA's f32 sqrt
    are. PyTorch's CPU sqrt is a vectorised approximation (an ulp off on
    ~0.6% of f32 inputs with torch 2.13, and in f64 too, so which
    elements round otherwise depends on how the threads split the
    tensor); on the CPU numpy's IEEE root is taken."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.detach().contiguous().numpy()))
    return torch.sqrt(x)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The dot of the last (size 3) axes, broadcast, summed in order:
    (a0 b0 + a1 b1) + a2 b2, as XLA's CPU build sums a 3-term jnp.sum or
    dot without FMA (tests/ray_order_probe.py order)."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + \
        a[..., 2] * b[..., 2]


def norm3(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """The length of the last (size 3) axis, sqrt_rn(dot3(x, x)): what
    chord_tpu's jitted jnp.linalg.norm over 3 components computes
    (torch.linalg.vector_norm sums and roots otherwise)."""
    n = sqrt_rn(dot3(x, x))
    return n[..., None] if keepdim else n


# --- sincosf: chord_tpu's f32 sin and cos -----------------------------------
#
# chord_tpu's XLA on the CPU calls the C library's sinf and cosf for an f32
# sin or cos. Those of glibc (>= 2.28; sysdeps/ieee754/flt-32/s_sinf.c,
# s_cosf.c, from ARM's optimized-routines) evaluate in f64: below 2^-12
# sin is x and cos 1; below 0.75 (the top 12 bits of pi/4) a polynomial in
# x; below 120 a fast reduction by pi/2 (an int32 truncation and an
# arithmetic shift pick the quadrant n); above, a reduction by the 4/pi
# bits of __inv_pio4 in 64-bit integers. The quadrant picks the sign of the
# reduced argument and the table: __sincosf_table[1] is [0] with the cosine
# coefficients negated. The constants are those of the library's tables
# (__sincosf_table, __inv_pio4). On an x86-64 CPU with FMA the library
# runs its FMA build (the IFUNC's __sinf_fma / __cosf_fma, which XLA's
# calls reach), where the compiler fused every a * b + c: the fast
# reduction x - n * pi/2 (vfnmadd132sd) and the polynomials' seven
# multiply-adds. The fused reduction shows near the multiples of pi/2
# (rounded twice, 34 of the f32 in (-120, 120) differ, e.g. cos(58.119465f)
# by an ulp): it is computed exactly as (x - n * hpi_hi) - n * hpi_lo, pi/2
# split into 26 and 27 significant bits (n < 2^7: both products and the
# first difference are exact, the second rounds once, as the fused one).
# The polynomials' fusion changes no f32 result there: unfused, each
# rounding once, they give the library's sinf and cosf on every f32 in
# (-120, 120) (tests/ray_order_probe.py trig) and on the tests' seeded
# inputs of every range.

_SC_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")    # 2^24 * 2 / pi
_SC_HPI_HI = float.fromhex("0x1.921fb5p+0")             # pi / 2 =
_SC_HPI_LO = float.fromhex("0x1.110b46p-26")            # hi + lo
_SC_PI63 = float.fromhex("0x1.921fb54442d18p-62")       # pi / 2^63 * 2
_SC_C = tuple(float.fromhex(v) for v in (              # c0 .. c4
    "0x1p+0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))
_SC_S = tuple(float.fromhex(v) for v in (              # s1 .. s3
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
    "-0x1.994eb3774cf24p-13"))
_INV_PIO4 = (
    0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44,
    0x6e4e4415, 0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1,
    0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62,
    0xc0db6295, 0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041)
# the top 12 bits (exponent and 3 mantissa bits) of |x| at the branches
_SC_TOP_TINY = 0x398        # 0x1p-12f
_SC_TOP_SMALL = 0x3f4       # 0x1.921fb6p-1f (pi/4)
_SC_TOP_FAST = 0x42f        # 120.0f
_SC_TOP_INF = 0x7f8


def _sincos_poly(x: torch.Tensor, x2: torch.Tensor):
    """glibc's sinf_poly of table 0, both branches -> (sine polynomial,
    cosine polynomial) in f64."""
    c0, c1, c2, c3, c4 = _SC_C
    s1, s2, s3 = _SC_S
    x3 = x * x2
    ps = s2 + x2 * s3
    x7 = x3 * x2
    sn = x + x3 * s1
    sn = sn + x7 * ps
    x4 = x2 * x2
    pc2 = c3 + x2 * c4
    pc1 = c0 + x2 * c1
    x6 = x4 * x2
    cs = pc1 + x4 * c2
    cs = cs + x6 * pc2
    return sn, cs


def sincosf_plain(x: torch.Tensor):
    """Plain version of the sincos kernel: f32 `x` -> (sin x, cos x) f32,
    bit for bit glibc's sinf and cosf (chord_tpu's XLA on the CPU), every
    range, in f64 torch ops on x's device."""
    if x.dtype != torch.float32:
        raise ValueError(f"sincosf takes float32 (got {x.dtype})")
    dev = x.device
    xi = bits_i32(x).to(torch.int64) & 0xFFFFFFFF
    top = (xi >> 20) & 0x7FF
    small = top < _SC_TOP_SMALL
    fast = top < _SC_TOP_FAST
    xd = x.double()
    # the fast reduction (|x| < 120): n = ((int32)(x * hpi_inv) + 2^23)
    # >> 24, r = x - n * pi/2 rounded once
    rf = torch.where(fast, xd * _SC_HPI_INV,
                     torch.zeros((), dtype=torch.float64, device=dev))
    n_fast = (torch.trunc(rf).to(torch.int32) + 0x800000) >> 24
    nd = n_fast.double()
    r_fast = (xd - nd * _SC_HPI_HI) - nd * _SC_HPI_LO
    # the large reduction: x's 24-bit mantissa times 96 bits of 4/pi, in
    # 64-bit integers (wrapping as unsigned arithmetic does)
    inv = torch.tensor(_INV_PIO4, dtype=torch.int64, device=dev)
    idx = (xi >> 26) & 15
    m = ((xi & 0xFFFFFF) | 0x800000) << ((xi >> 23) & 7)
    r0 = (m * inv[idx]) & 0xFFFFFFFF
    r1 = m * inv[idx + 4]
    r2 = m * inv[idx + 8]
    r0 = ((r2 >> 32) | (r0 << 32)) + r1
    n_large = ((r0 + (1 << 61)) >> 62) & 3
    r_large = (r0 - (n_large << 62)).double() * _SC_PI63
    n = torch.where(fast, n_fast.to(torch.int64), n_large)
    # the sign and table index: the large branch adds x's sign bit
    q = torch.where(fast, n, n + (xi >> 31)) & 3
    r = torch.where(fast, r_fast, r_large)
    neg = (q == 1) | (q == 2)
    rs = torch.where(neg, -r, r)
    xin = torch.where(small, xd, rs)
    x2 = torch.where(small, xd * xd, r * r)
    sn, cs = _sincos_poly(xin, x2)
    # table 1 (q & 2) negates the cosine coefficients: -cs, exactly
    cs = torch.where(~small & (q >= 2), -cs, cs)
    odd = ~small & ((n & 1) == 1)
    sin = torch.where(odd, cs, sn).float()
    cos = torch.where(odd, sn, cs).float()
    tiny = top < _SC_TOP_TINY
    sin = torch.where(tiny, x, sin)
    cos = torch.where(tiny, torch.ones((), device=dev), cos)
    bad = top >= _SC_TOP_INF
    nan = torch.full((), float("nan"), device=dev)
    return torch.where(bad, nan, sin), torch.where(bad, nan, cos)


def sincos_cuda(x: torch.Tensor):
    """Launch the sincos kernel (csrc/sincos.cu) on a contiguous f32 CUDA
    tensor -> (sin, cos), one launch for both planes; an empty tensor
    launches nothing."""
    _cuda.check(x, "x", torch.float32)
    s, c = torch.empty_like(x), torch.empty_like(x)
    if x.numel() == 0:
        return s, c
    if x.numel() >= 2 ** 31:
        raise ValueError("sincosf: at most 2^31 - 1 elements a call")
    _cuda.launch("chord_sincosf", _cuda.ptr(x), _cuda.ptr(s), _cuda.ptr(c),
                 _cuda.cint(x.numel()), _cuda.stream())
    sincosf.launches += 1
    return s, c


def sincosf(x: torch.Tensor):
    """f32 (sin x, cos x) as chord_tpu's XLA computes them (glibc's sinf
    and cosf): a CPU tensor through sincosf_plain, a CUDA tensor through
    the sincos kernel (contiguous, or it raises). Callers reach it as
    `_util.sincosf`, so kernels.capture_inputs sees the calls."""
    if not x.is_cuda:
        return sincosf_plain(x)
    return sincos_cuda(x)


sincosf.launches = 0


def jitter_rays(base: np.ndarray, frame: int, tilt: float) -> np.ndarray:
    """A frame's ray set (R,3) f32: `base` (R,3) rotated by the frame's
    jitter, base @ (Rz(a) Rx(b))^T with the golden-angle azimuth
    a = f32(frame) * f32(2.3999632297286533) and b = f32(frame) *
    f32(tilt), rounded as chord_tpu's compiled _jitter_rotation and its
    product round it without FMA, and the same on every device: computed
    on the host, the angles' cos and sin by sincosf_plain (XLA's f32 cos
    and sin on the CPU), every product of the 3x3 rotations summed
    (p0 + p1) + p2, one rounding an operation (a device's matmul and trig
    round otherwise)."""
    f32 = np.float32
    a = f32(frame) * f32(2.3999632297286533)
    b = f32(frame) * f32(tilt)
    s, c = sincosf_plain(torch.tensor([a, b], dtype=torch.float32))
    sa, sb = s.numpy()
    ca, cb = c.numpy()
    rz = np.array([[ca, -sa, 0.0], [sa, ca, 0.0], [0.0, 0.0, 1.0]], f32)
    rx = np.array([[1.0, 0.0, 0.0], [0.0, cb, -sb], [0.0, sb, cb]], f32)
    rot = (rz[:, 0, None] * rx[0] + rz[:, 1, None] * rx[1]) + \
        rz[:, 2, None] * rx[2]
    base = np.asarray(base, f32)
    return ((base[:, 0, None] * rot[:, 0] + base[:, 1, None] * rot[:, 1])
            + base[:, 2, None] * rot[:, 2])


def host_table(table: np.ndarray, device) -> torch.Tensor:
    """A host table on `device` by a pinned, non-blocking copy: no
    synchronisation."""
    t = torch.from_numpy(table)
    if torch.device(device).type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def bits_i32(x: torch.Tensor) -> torch.Tensor:
    """f32 / i32 -> int32 bit pattern (no conversion)."""
    return x.contiguous().view(torch.int32) if x.dtype != torch.int32 else x


def bits_f32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> f32."""
    return x.contiguous().view(torch.float32)


@functools.lru_cache(maxsize=None)
def const(values, device: torch.device) -> torch.Tensor:
    """An f32 constant (a float or a tuple) on `device`, made once: a
    host-to-device copy inside a frame would synchronise the stream."""
    return torch.tensor(values, dtype=torch.float32, device=device)
