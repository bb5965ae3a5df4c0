"""Small tensor helpers shared by the ops."""

from __future__ import annotations

import ctypes
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


def rsqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """1 / sqrt_rn(x): what chord_tpu's jitted lax.rsqrt computes on the
    CPU (the root and the division each rounded to nearest). CUDA's
    rsqrtf, which torch.rsqrt takes on the card, is an approximation."""
    return 1.0 / sqrt_rn(x)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The dot of the last (size 3) axes, broadcast, summed in order:
    (a0 b0 + a1 b1) + a2 b2, as XLA's CPU build sums a 3-term jnp.sum or
    dot without FMA (tests/ray_order_probe.py order)."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + \
        a[..., 2] * b[..., 2]


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """f32 a * b + c rounded once, a fused multiply-add, the same on every
    device: in f64 the product of two f32 is exact; the sum is taken to
    odd (where TwoSum's error shows it inexact and its last bit is even,
    the neighbour toward the error), so that rounding it to f32 is the one
    rounding of the exact value. The libraries chord_tpu's XLA calls on
    the CPU (OpenBLAS's kernels, the runtime's batched dot) fuse so."""
    a, b, c = a.double(), b.double(), c.double()
    p = a * b
    s = p + c
    z = s - p
    err = (p - (s - z)) + (c - z)
    even = (s.view(torch.int64) & 1) == 0
    inf = torch.full((), float("inf"), dtype=torch.float64, device=s.device)
    s = torch.where((err != 0) & even,
                    torch.nextafter(s, torch.copysign(inf, err)), s)
    return s.float()


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


# --- powf: chord_tpu's f32 x ** y for a float y -----------------------------
#
# chord_tpu's `x ** 8.0` (a Python float exponent: the specular filters'
# edge weight, chord_tpu screen_probe.py:631) is an XLA power, which its
# CPU build computes by the C library's powf (glibc >= 2.28, ARM's
# optimized-routines algorithm: log2 in f64 from a 16-entry table and a
# degree-5 polynomial, times y, then exp2 from a 32-entry table and a
# cubic), its f32 result flushed to zero below 2^-126 (XLA's threads run
# with FTZ and DAZ; a jitted power differs from the library there only).
# The constants are the library's (__powf_log2_data, __exp2f_data, found
# byte for byte in glibc's libm.so.6). Its FMA build fuses the reduction
# r = z * invc - 1: computed exactly here as (z * hi - 1) + z * lo, invc
# split into 26 and 27 significant bits (z has 24: both products and the
# difference, by Sterbenz, exact; the sum rounds once, as the fused one).
# Its fused polynomial steps change no f32 result on the tests' inputs
# (every f32 in [2^-126, 1] with y = 8, tests/ray_order_probe.py powf),
# so they stay unfused. An integer exponent (`x ** 8`) is XLA's
# integer_pow, repeated squaring, not this.

_PW_LOG2 = tuple(tuple(float.fromhex(v) for v in p) for p in (
    ("0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2"),
    ("0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2"),
    ("0x1.49539f0f010bp+0", "-0x1.7418b0a1fb77bp-2"),
    ("0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2"),
    ("0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2"),
    ("0x1.25e227b0b8eap+0", "-0x1.97c1d1b3b7afp-3"),
    ("0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3"),
    ("0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4"),
    ("0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5"),
    ("0x1p+0", "0x0p+0"),
    ("0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4"),
    ("0x1.ca4b31f026aap-1", "0x1.476a9543891bap-3"),
    ("0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3"),
    ("0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2"),
    ("0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2"),
    ("0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2")))
_PW_A = tuple(float.fromhex(v) for v in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp0"))
# exp2: tab[i] = bits(2^(i/32)) - (i << 47)
_PW_EXP2 = (
    0x3ff0000000000000, 0x3fefd9b0d3158574, 0x3fefb5586cf9890f,
    0x3fef9301d0125b51, 0x3fef72b83c7d517b, 0x3fef54873168b9aa,
    0x3fef387a6e756238, 0x3fef1e9df51fdee1, 0x3fef06fe0a31b715,
    0x3feef1a7373aa9cb, 0x3feedea64c123422, 0x3feece086061892d,
    0x3feebfdad5362a27, 0x3feeb42b569d4f82, 0x3feeab07dd485429,
    0x3feea47eb03a5585, 0x3feea09e667f3bcd, 0x3fee9f75e8ec5f74,
    0x3feea11473eb0187, 0x3feea589994cce13, 0x3feeace5422aa0db,
    0x3feeb737b0cdc5e5, 0x3feec49182a3f090, 0x3feed503b23e255d,
    0x3feee89f995ad3ad, 0x3feeff76f2fb5e47, 0x3fef199bdd85529c,
    0x3fef3720dcef9069, 0x3fef5818dcfba487, 0x3fef7c97337b9b5f,
    0x3fefa4afa2a490da, 0x3fefd0765b6e4540)
_PW_C = tuple(float.fromhex(v) for v in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1"))
_PW_SHIFT = float.fromhex("0x1.8p+47")          # 0x1.8p52 / 32
_PW_OFLOW = float.fromhex("0x1.fffffffd1d571p+6")


def _split26(v: float):
    """v = hi + lo, hi with 26 significant bits (Veltkamp)."""
    c = v * 134217729.0
    hi = c - (c - v)
    return hi, v - hi


def powf_plain(x: torch.Tensor, y: float) -> torch.Tensor:
    """Plain version of the powf kernel: f32 `x` >= 0 (or NaN) to the
    power of the f32 `y` > 0, bit for bit what chord_tpu's XLA computes on
    the CPU (glibc's powf, FTZ / DAZ), in f64 torch ops on x's device. A
    negative x gives NaN."""
    if x.dtype != torch.float32:
        raise ValueError(f"powf takes float32 (got {x.dtype})")
    y = float(np.float32(y))
    if not 0.0 < y < float("inf"):
        raise ValueError(f"powf takes a finite y > 0 (got {y})")
    dev = x.device
    f64 = dict(dtype=torch.float64, device=dev)
    tab = torch.tensor(_PW_LOG2, **f64)
    hi_lo = torch.tensor([_split26(c) for c, _ in _PW_LOG2], **f64)
    t2 = torch.tensor(_PW_EXP2, dtype=torch.int64, device=dev)
    xi = bits_i32(x).to(torch.int64) & 0xFFFFFFFF
    tmp = (xi - 0x3F330000) & 0xFFFFFFFF
    i = (tmp >> 19) & 15
    top = tmp & 0xFF800000
    z = bits_f32(((xi - top) & 0xFFFFFFFF).to(torch.int32)).double()
    k = ((top ^ 0x80000000) - 0x80000000) >> 23
    a0, a1, a2, a3, a4 = _PW_A
    r = (z * hi_lo[i, 0] - 1.0) + z * hi_lo[i, 1]
    r2 = r * r
    lg = a0 * r + a1
    p = a2 * r + a3
    r4 = r2 * r2
    q = a4 * r + (tab[i, 1] + k.double())
    q = p * r2 + q
    lg = lg * r4 + q
    e = y * lg
    kd = (e + _PW_SHIFT) - _PW_SHIFT          # e to a multiple of 1/32
    rr = e - kd
    kk = (kd * 32.0).to(torch.int64)
    s = (t2[kk & 31] + kk * (1 << 47)).view(torch.float64)
    c0, c1, c2 = _PW_C
    zz = c0 * rr + c1
    out = zz * (rr * rr) + (c2 * rr + 1.0)
    out = (out * s).float()
    zero = torch.zeros((), device=dev)
    inf = torch.full((), float("inf"), device=dev)
    out = torch.where(e > _PW_OFLOW, inf, out)
    # underflow and FTZ; DAZ: a zero or subnormal x is 0
    out = torch.where((e <= -150.0) | (out < 2.0 ** -126) |
                      (x < 2.0 ** -126), zero, out)
    out = torch.where(x == float("inf"), inf, out)
    return torch.where(torch.isnan(x) | (x < 0), torch.full(
        (), float("nan"), device=dev), out)


def powf_cuda(x: torch.Tensor, y: float) -> torch.Tensor:
    """Launch the powf kernel (csrc/powf.cu) on a contiguous f32 CUDA
    tensor; an empty tensor launches nothing."""
    _cuda.check(x, "x", torch.float32)
    y = float(np.float32(y))
    if not 0.0 < y < float("inf"):
        raise ValueError(f"powf takes a finite y > 0 (got {y})")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    if x.numel() >= 2 ** 31:
        raise ValueError("powf: at most 2^31 - 1 elements a call")
    _cuda.launch("chord_powf", _cuda.ptr(x), _cuda.ptr(out),
                 ctypes.c_float(y), _cuda.cint(x.numel()), _cuda.stream())
    powf.launches += 1
    return out


def powf(x: torch.Tensor, y: float) -> torch.Tensor:
    """f32 x ** y for a float y as chord_tpu's XLA computes it (glibc's
    powf): a CPU tensor through powf_plain, a CUDA tensor through the
    powf kernel (contiguous, or it raises). Callers reach it as
    `_util.powf`, so kernels.capture_inputs sees the calls."""
    if not x.is_cuda:
        return powf_plain(x, y)
    return powf_cuda(x, y)


powf.launches = 0


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
