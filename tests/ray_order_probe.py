"""One-off CPU probes of how the port's ray sets, ray tests, trig and
short sums round against chord_tpu's compiled ones (not tests: the tier-1
run's XLA keeps FMA, these compile chord_tpu without it, as the bench
goldens are).

    python tests/ray_order_probe.py order        # ~15 s
    python tests/ray_order_probe.py ddgi-frames  # ~10 s
    python tests/ray_order_probe.py directions   # ~1 min
    python tests/ray_order_probe.py sites        # ~20 s
    python tests/ray_order_probe.py trig         # ~15 min
    python tests/ray_order_probe.py powf         # ~5 min

`order`: chord_tpu's jitted _ray_sphere, trace_dense_tri and trace_bvh
(over a triangle and a sphere BVH, at the default budget and a short one)
against the numpy f32 oracles of tests/test_torch_ray_rounding.py (each
3-term dot summed (p0 + p1) + p2), a size-3 jnp.sum against both
association orders, jnp.linalg.norm over 3 components against
_util.norm3 and 1 / jnp.sqrt against f32(1) / sqrt_rn: what XLA's CPU
build does.

`ddgi-frames`: frames 0-63 on which the port's ddgi.ray_table (and
screen_probe.ray_table) differs from chord_tpu's jitted
`fib @ _jitter_rotation(f).T`, and those of them on which XLA's f32 cos or
sin of the frame's angles differs from the port's (_util.sincosf_plain).

`directions`: RTAO's per-pixel ray directions (ops/gi.py rtao) and the
specular GI's GGX reflection directions (renderer/meshlet_frame.py
specular_directions against chord_tpu's frame lines, tests/
bench_goldens.py jax_specular_directions) at 128x64 over frames 0-7, each
package with its own noise (the port's eager IGN, chord_tpu's jitted one),
on seeded surface points of a triangle soup seen from a seeded camera:
the share of rays whose direction differs from chord_tpu's, and the share
whose trace result (t bits or leaf; each package's own trace of its own
rays over the same BVH) then differs.

`sites`: the frame's other short norms, roots and 3-term sums (the sites
named in `SITES`): on seeded 128x64 inputs the port's expression against
chord_tpu's jitted one, the share of elements that differ.

`sites` also holds the per-object motion delta (shading.rigid_delta
against jitted jnp.linalg.inv and einsum on seeded rigid 4x4 matrices) and
SSR's toward_cam; each repaired site prints "as it was" (the port's old
expression) and "now" (the port's own function where it has one).

`powf`: _util.powf_plain on every f32 in [2^-126, 1] with y = 8 (the
edge weight's `** 8.0`; XLA's power on the CPU is the C library's powf
with denormals flushed) and on seeded inputs of other exponents, against
the C library's powf (compiled with `cc` as for `trig`) with XLA's flush,
and jitted chord_tpu's `x ** 8.0` on a seeded sample.

`trig`: _util.sincosf_plain on every f32 in (-120, 120), the fast
reduction's range, against the C library's sinf / cosf (what XLA calls;
a batch helper is compiled with `cc` into a temporary directory), and the
count that differs with the reduction x - n * pi/2 rounded twice (the
library's FMA build fuses it).

XLA_FLAGS=--xla_cpu_max_isa=SSE4_2 and JAX_PLATFORMS=cpu are set here.
"""

from __future__ import annotations

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = " ".join(
    [os.environ.get("XLA_FLAGS", ""), "--xla_cpu_max_isa=SSE4_2"]).strip()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import numpy as np  # noqa: E402

F32 = np.float32


def _equal(name, a, b) -> None:
    a, b = np.asarray(a), np.asarray(b)
    print(f"{name}: equal {np.array_equal(a, b)} ({int((a != b).sum())} of "
          f"{a.size} differ)", flush=True)


def order() -> None:
    import jax
    import jax.numpy as jnp

    from chord_tpu.ops import rt as jrt
    from chord_tpu_torch.ops import rt
    from rt_cases import rays, spheres, tri_bvh, tri_rays, triangles
    import test_torch_ray_rounding as tr

    rng = np.random.default_rng(5)
    o = (rng.standard_normal((20000, 3)) * 10).astype(F32)
    d = rng.standard_normal((20000, 3)).astype(F32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    c = (rng.standard_normal((20000, 3)) * 10).astype(F32)
    oc = (o - c).astype(np.float64)
    b = (oc * d).sum(1)
    dist = np.sqrt(np.maximum((oc * oc).sum(1) - b * b, 0.0))
    r = (dist * (1 + rng.uniform(-1e-6, 1e-6, 20000))).astype(F32)
    sph = np.concatenate([c, r[:, None]], 1).astype(F32)
    jh, jt = jax.jit(jrt._ray_sphere)(o, d, sph)
    oh, ot = tr._ray_sphere_oracle(o, d, sph)
    _equal("_ray_sphere hit (near-tangent rays)", jh, oh)
    _equal("_ray_sphere t_entry", jt, ot)
    x = o - sph[:, :3]
    s = np.asarray(jax.jit(lambda a, b: jnp.sum(a * b, -1))(x, d))
    _equal("jnp.sum of 3 against (p0 + p1) + p2", s, tr._dot3(x, d))
    _equal("jnp.sum of 3 against p0 + (p1 + p2)", s,
           x[:, 0] * d[:, 0] + (x[:, 1] * d[:, 1] + x[:, 2] * d[:, 2]))
    v0, e1, e2 = triangles(700, 0)
    to, td = tri_rays(v0, e1, e2, 3000, 1)
    bvh, _ = tri_bvh(v0, e1, e2)
    planes = bvh.tri_planes.numpy()
    jt, jl = jax.jit(jrt.trace_dense_tri)(to, td, planes)
    wt, wl = tr._dense_tri_oracle(to, td, planes)
    _equal("trace_dense_tri t", jt, wt)
    _equal("trace_dense_tri leaf", jl, wl)
    jb = jrt.SceneBVH(**{f: None if v is None else jnp.asarray(v.numpy())
                         for f, v in bvh._asdict().items()})
    for steps in (None, 40):
        f = jax.jit(lambda o, d, b, s=steps: jrt.trace_bvh(o, d, b,
                                                           max_steps=s))
        jt, jl = f(to, td, jb)
        wt, wl = tr._scan_oracle(to, td, bvh.node_sphere.numpy(),
                                 bvh.node_count.numpy(),
                                 bvh.node_leaf.numpy(), planes,
                                 max_steps=steps)
        _equal(f"trace_bvh triangles, max_steps {steps} t", jt, wt)
        _equal(f"trace_bvh triangles, max_steps {steps} leaf", jl, wl)
    import torch

    from chord_tpu_torch.ops import _util

    v = (rng.standard_normal((200000, 3)) * 10).astype(F32)
    jn = np.asarray(jax.jit(lambda a: jnp.linalg.norm(a, axis=-1))(v))
    _equal("jnp.linalg.norm of 3 against _util.norm3", jn,
           _util.norm3(torch.from_numpy(v)).numpy())
    _equal("jnp.linalg.norm of 3 against torch.linalg.vector_norm", jn,
           torch.linalg.vector_norm(torch.from_numpy(v), dim=-1).numpy())
    x = rng.uniform(1e-3, 100.0, 200000).astype(F32)
    _equal("1 / jnp.sqrt against f32(1) / _util.sqrt_rn",
           np.asarray(jax.jit(lambda a: 1.0 / jnp.sqrt(a))(x)),
           (1.0 / _util.sqrt_rn(torch.from_numpy(x))).numpy())
    sp_ = spheres(700, 0)
    so, sd = rays(3000, 1)
    nb = rt.build_bvh_numpy(sp_)
    jbs = jrt.SceneBVH(node_sphere=jnp.asarray(nb["sphere"]),
                       node_count=jnp.asarray(nb["count"]),
                       node_leaf=jnp.asarray(nb["leaf"]),
                       leaf_albedo=jnp.ones((700, 3)),
                       leaf_emissive=jnp.zeros((700, 3)),
                       leaf_sphere=jnp.asarray(sp_))
    for steps in (None, 30):
        f = jax.jit(lambda o, d, b, s=steps: jrt.trace_bvh(o, d, b,
                                                           max_steps=s))
        jt, jl = f(so, sd, jbs)
        wt, wl = tr._scan_oracle(so, sd, nb["sphere"], nb["count"],
                                 nb["leaf"], max_steps=steps)
        _equal(f"trace_bvh spheres, max_steps {steps} t", jt, wt)
        _equal(f"trace_bvh spheres, max_steps {steps} leaf", jl, wl)


def ddgi_frames() -> None:
    import jax
    import jax.numpy as jnp

    import torch

    from chord_tpu.ops import ddgi as jd
    from chord_tpu.ops import screen_probe as jsp
    from chord_tpu_torch.ops import _util, ddgi
    from chord_tpu_torch.ops import screen_probe as sp

    n = jd.DDGIConfig().rays
    fib = jnp.asarray(jd.spherical_fibonacci(n))
    table = jax.jit(lambda f: fib @ jd._jitter_rotation(f).T)
    octa = jnp.asarray(jsp._octahedral_dirs(4))
    probe = jax.jit(lambda f: octa @ jsp._jitter_rotation(f).T)

    def trig(tilt):
        def f(fc):
            x = fc.astype(jnp.float32)
            a, b = x * 2.3999632297286533, x * tilt
            return jnp.stack([jnp.cos(a), jnp.sin(a), jnp.cos(b),
                              jnp.sin(b)])
        return jax.jit(f)

    for name, want, got, tilt, size in (
            ("ddgi.ray_table", table, lambda f: ddgi.ray_table(f, n), 1.7,
             n * 3),
            ("screen_probe.ray_table", probe, lambda f: sp.ray_table(f, 16),
             1.1, 48)):
        xla_trig = trig(tilt)
        off, comps, trig_off = [], 0, {}
        for f in range(64):
            a, b = np.asarray(want(jnp.int32(f))), got(f)
            if (a != b).any():
                off.append(f)
                comps += int((a != b).sum())
            x = F32(f)
            ang = torch.tensor([x * F32(2.3999632297286533), x * F32(tilt)])
            s_, c_ = _util.sincosf_plain(ang)
            host = np.array([c_[0], s_[0], c_[1], s_[1]], F32)
            t = np.asarray(xla_trig(jnp.int32(f)))
            if (t != host).any():
                trig_off[f] = [("cos a", "sin a", "cos b", "sin b")[k]
                               for k in range(4) if t[k] != host[k]]
        print(f"{name} ({size} components a frame): differs from "
              f"chord_tpu's jitted rotation on frames {off} ({comps} of "
              f"{64 * size} components); XLA's f32 cos / sin differ from "
              f"_util.sincosf_plain's on frames {trig_off}", flush=True)


def directions(frames: int = 8, h: int = 64, w: int = 128) -> None:
    import jax
    import jax.numpy as jnp
    import torch

    from bench_goldens import jax_specular_directions
    from chord_tpu.ops import gi as jgi
    from chord_tpu.ops import rt as jrt
    from chord_tpu.ops import screen_probe as jsp
    from chord_tpu_torch.ops import gi, rt
    from chord_tpu_torch.ops import screen_probe as sp
    from chord_tpu_torch.ops.bluenoise import interleaved_gradient_noise
    from chord_tpu_torch.renderer.meshlet_frame import specular_directions
    from rt_cases import tri_bvh, triangles

    v0, e1, e2 = (x * F32(0.3) for x in triangles(2000, 3))
    bvh, _ = tri_bvh(v0, e1, e2)
    jb = jrt.SceneBVH(**{f: None if v is None else jnp.asarray(v.numpy())
                         for f, v in bvh._asdict().items()})
    rng = np.random.default_rng(4)
    k = rng.integers(0, len(v0), h * w)
    uv = rng.uniform(0, 1, (h * w, 2))
    uv = np.where(uv.sum(1, keepdims=True) > 1, 1 - uv, uv)
    pos = (v0[k] + uv[:, :1] * e1[k] + uv[:, 1:] * e2[k]).astype(F32)
    nrm = np.cross(e1[k], e2[k])
    nrm = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    cam = rng.uniform(-8, 8, 3)
    flip = ((cam - pos) * nrm).sum(1, keepdims=True) < 0
    nrm = np.where(flip, -nrm, nrm).astype(F32)
    pos, nrm = pos.reshape(h, w, 3), nrm.reshape(h, w, 3)
    pos_tw = (pos - cam).astype(F32)      # the frame's: camera at 0
    rough = rng.uniform(0.05, 0.9, (h, w)).astype(F32)
    cfg, jcfg = gi.GIConfig(), jgi.GIConfig()

    def spy(store, orig):
        def f(o, d, b, t_max=1e9, max_steps=None):
            store.append((o, d))
            return orig(o, d, b, t_max, max_steps)
        return f

    jcalls = []
    jtrace = jrt.trace

    def j_rtao(p, n, b, fc):
        jcalls.clear()
        ao = jgi.rtao(p, n, b, jcfg, frame_index=fc)
        return ao, [d for _, d in jcalls]

    jrt.trace = spy(jcalls, jtrace)
    try:
        rtao_j = jax.jit(j_rtao)
        ggx_j = jax.jit(jax_specular_directions)
        half_j = jax.jit(jsp.ggx_sample_normal)
        trace_j = jax.jit(lambda o, d, b, tm: jtrace(o, d, b, t_max=tm))
        tot = {k: np.zeros(3, np.int64) for k in ("rtao", "ggx")}
        half_off = 0
        for f in range(frames):
            fc = jnp.int32(f)
            _, jd = rtao_j(pos, nrm, jb, fc)
            pcalls = []
            orig = rt.trace
            rt.trace = spy(pcalls, orig)
            rt.trace.calls = rt.trace.dense = rt.trace.rays = 0
            try:
                gi.rtao(torch.from_numpy(pos), torch.from_numpy(nrm), bvh,
                        cfg, frame_index=torch.tensor(f, dtype=torch.int32))
            finally:
                rt.trace = orig
            org = pos + nrm * F32(0.05)
            pairs = [("rtao", np.asarray(a), b.numpy(), cfg.ao_radius)
                     for a, b in zip(jd, [d for _, d in pcalls])]
            _, refl = specular_directions(
                torch.from_numpy(pos_tw), torch.from_numpy(nrm),
                torch.from_numpy(rough), torch.tensor(f, dtype=torch.int32))
            pairs.append(("ggx", np.asarray(ggx_j(pos_tw, nrm, rough, fc)),
                          refl.numpy(), 1e9))
            # ggx_sample_normal alone, on the same view and noise
            u1 = interleaved_gradient_noise(h, w, f, device="cpu")
            u2 = interleaved_gradient_noise(h, w, f + 31, device="cpu")
            view = pos_tw / -np.sqrt(((pos_tw[..., 0] * pos_tw[..., 0] +
                                       pos_tw[..., 1] * pos_tw[..., 1]) +
                                      pos_tw[..., 2] * pos_tw[..., 2]))[
                ..., None]
            hp = sp.ggx_sample_normal(torch.from_numpy(nrm),
                                      torch.from_numpy(view),
                                      torch.from_numpy(rough), u1, u2)
            hj = half_j(nrm, view, rough, u1.numpy(), u2.numpy())
            half_off += int((np.asarray(hj) != hp.numpy()).any(-1).sum())
            for name, dj, dp, t_max in pairs:
                moved = (dj != dp).any(-1)
                tj, lj = trace_j(org, dj, jb, F32(t_max))
                tp, lp = rt.trace(torch.from_numpy(org), torch.from_numpy(dp),
                                  bvh, t_max)
                hit = (np.asarray(tj).view(np.int32) !=
                       tp.numpy().view(np.int32)) | (np.asarray(lj) !=
                                                     lp.numpy())
                tot[name] += (moved.size, int(moved.sum()), int(hit.sum()))
        for name, (n, moved, hit) in tot.items():
            print(f"{name} at {w}x{h}, frames 0-{frames - 1}: {n} rays; "
                  f"direction differs from chord_tpu's on {moved} "
                  f"({moved / n:.4%}); trace result (t bits or leaf) "
                  f"differs on {hit} ({hit / n:.4%})", flush=True)
        print(f"ggx_sample_normal alone on the same view and noise, frames "
              f"0-{frames - 1}: differs from chord_tpu's on {half_off} of "
              f"{frames * h * w} half-vectors", flush=True)
    finally:
        jrt.trace = jtrace


def _site_inputs(h: int, w: int) -> dict:
    """Seeded 128x64-class planes: camera-relative positions, unit
    normals, nearly unit (interpolated) normals, probe positions."""
    rng = np.random.default_rng(8)

    def unit(shape):
        v = rng.standard_normal(shape + (3,))
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(F32)

    x = dict(pos=rng.uniform(-20, 20, (h, w, 3)).astype(F32),
             nrm=unit((h, w)),
             nrm_i=(unit((h, w)) * rng.uniform(0.9, 1.1, (h, w, 1))
                    ).astype(F32),
             pos2=rng.uniform(-20, 20, (h, w, 3)).astype(F32),
             dirs=(unit((h, w)) * rng.uniform(0.5, 2.0, (h, w, 1))
                   ).astype(F32))
    # neighbours near the centre (the edge weight's live range), a sun
    # per pixel, and the instance table's rigid matrices (row vectors:
    # scaled rotation, translation up to +-80; a tenth moved by up to 0.2)
    rng = np.random.default_rng(9)
    x["pos_near"] = (x["pos"] + rng.normal(0, 0.3, (h, w, 3))).astype(F32)
    x["sun"] = unit((h, w))
    nn = x["nrm"] + rng.normal(0, 0.15, (h, w, 3))
    x["nrm_near"] = (nn / np.linalg.norm(nn, axis=-1, keepdims=True)
                     ).astype(F32)
    x["mats"], x["mats_prev"] = rigid_mats(rng, 875)
    return x


def rigid_mats(rng, n: int):
    """n seeded rigid (O,4,4) f32 object matrices in chord_tpu's row-vector
    convention and their previous frame's (a tenth moved by up to 0.2)."""
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, a, b, c = q.T
    rot = np.stack([1 - 2 * (b * b + c * c), 2 * (a * b - c * w),
                    2 * (a * c + b * w), 2 * (a * b + c * w),
                    1 - 2 * (a * a + c * c), 2 * (b * c - a * w),
                    2 * (a * c - b * w), 2 * (b * c + a * w),
                    1 - 2 * (a * a + b * b)], -1).reshape(n, 3, 3)
    m = np.zeros((n, 4, 4))
    m[:, :3, :3] = rot * rng.uniform(0.5, 3.0, (n, 1, 1))
    m[:, 3, :3] = rng.uniform(-80, 80, (n, 3))
    m[:, 3, 3] = 1.0
    mp = m.copy()
    moved = rng.random(n) < 0.1
    mp[moved, 3, :3] += rng.uniform(-0.2, 0.2, (int(moved.sum()), 3))
    return m.astype(F32), mp.astype(F32)


def _sites():
    """(site, inputs, the port's expression (torch), chord_tpu's (jnp)):
    each site's statements as the port writes them and as chord_tpu does
    (file:line of the port; the repaired sites as they were and as they
    are)."""
    import jax.numpy as jnp
    import torch

    from chord_tpu.ops import screen_probe as jsp
    from chord_tpu_torch.ops import screen_probe as sp
    from chord_tpu.ops import colorspace as jcs
    from chord_tpu_torch.ops import colorspace, shading
    from chord_tpu_torch.ops._util import dot3, norm3, recip

    vn = torch.linalg.vector_norm
    jn = jnp.linalg.norm

    def roll(x):
        return torch.roll(x, (1, 3), (0, 1))

    def jroll(x):
        return jnp.roll(x, (1, 3), (0, 1))

    def taps_port(norm, dot):
        def f(p, n):
            d = roll(p) - p
            dist = norm(d)
            dirn = d / torch.clamp_min(dist[..., None], 1e-6)
            return dist, dot(dirn, n)
        return f

    def taps_jax(p, n):
        d = jroll(p) - p
        dist = jn(d, axis=-1)
        dirn = d / jnp.maximum(dist[..., None], 1e-6)
        return dist, jnp.sum(dirn * n, -1)

    def probe_port(norm, dot):
        def f(pp, p, n):
            t = pp - p
            dist = norm(t)
            dr = t / torch.clamp_min(dist[..., None], 1e-6)
            return dist, dot(dr, n)
        return f

    def probe_jax(pp, p, n):
        t = pp - p
        dist = jn(t, axis=-1)
        dr = t / jnp.maximum(dist[..., None], 1e-6)
        return dist, jnp.sum(dr * n, -1)

    def unit_port(norm, eps):
        return lambda x: (x / torch.clamp_min(norm(x)[..., None], eps),)

    def unit_jax(eps):
        return lambda x: (x / jnp.maximum(jn(x, axis=-1, keepdims=True),
                                          eps),)

    def ssr_port(norm, dot):
        def f(p, n):
            v = -p / torch.clamp_min(norm(p)[..., None], 1e-6)
            return v, 2.0 * dot(v, n)[..., None] * n - v
        return f

    def ssr_jax(p, n):
        v = -p / jnp.maximum(jn(p, axis=-1, keepdims=True), 1e-6)
        return v, 2.0 * jnp.sum(v * n, -1, keepdims=True) * n - v

    def edge_port(pc, ps, nc, ns):
        nf = torch.clamp((nc * ns).sum(-1), 0.0, 1.0) ** 8
        scale = torch.clamp_min(vn(pc, dim=-1), 1e-3)
        df = torch.clamp(1.0 - vn(ps - pc, dim=-1) / scale, 0.0, 1.0)
        return nf, df, (nf * df) ** 8.0

    def edge_jax(pc, ps, nc, ns):
        nf = jnp.clip(jnp.sum(nc * ns, -1), 0.0, 1.0) ** 8
        scale = jnp.maximum(jn(pc, axis=-1), 1e-3)
        df = jnp.clip(1.0 - jn(ps - pc, axis=-1) / scale, 0.0, 1.0)
        return nf, df, (nf * df) ** 8.0

    def norm3_port(x):
        return (torch.sqrt((x * x).sum(dim=-1, keepdim=True)),)

    def nov_port(p, n):
        return (torch.clamp((-p / torch.clamp_min(vn(p, dim=-1, keepdim=True),
                                                  1e-6) * n).sum(-1),
                            1e-3, 1.0),)

    def nov_jax(p, n):
        return (jnp.clip(jnp.sum(-p / jnp.maximum(jn(p, axis=-1,
                                                     keepdims=True), 1e-6)
                                 * n, -1), 1e-3, 1.0),)

    def vnorm(x):
        return vn(x, dim=-1)

    def edge_now(pc, ps, nc, ns):
        base = sp._edge_base(pc, nc, ps, ns)
        nf = torch.clamp(dot3(nc, ns), 0.0, 1.0)
        nf = nf * nf
        nf = nf * nf
        return nf * nf, base, sp._edge_weight(pc, nc, ps, ns)

    def edge_jax_parts(pc, ps, nc, ns):
        nf = jnp.clip(jnp.sum(nc * ns, -1), 0.0, 1.0) ** 8
        return nf, jsp_base(pc, ps, nc, ns), jsp._edge_weight(pc, nc, ps, ns)

    def jsp_base(pc, ps, nc, ns):
        nf = jnp.clip(jnp.sum(nc * ns, -1), 0.0, 1.0) ** 8
        scale = jnp.maximum(jn(pc, axis=-1), 1e-3)
        return nf * jnp.clip(1.0 - jn(ps - pc, axis=-1) / scale, 0.0, 1.0)

    def toward_was(p, n):
        v, r = ssr_port(norm3, dot3)(p, n)
        return ((r * v).sum(-1),)

    def toward_now(p, n):
        v, r = ssr_port(norm3, dot3)(p, n)
        return (dot3(r, v),)

    def toward_jax(p, n):
        v, r = ssr_jax(p, n)
        return (jnp.sum(r * v, -1),)

    def ssao_was(p, n):
        dist, s_ = taps_port(vnorm, sumdot)(p, n)
        return dist, s_, 1.0 - dist / 1.5

    def ssao_now(p, n):
        dist, s_ = taps_port(norm3, dot3)(p, n)
        return dist, s_, 1.0 - dist * recip(1.5)

    def ssao_jax(p, n):
        dist, s_ = taps_jax(p, n)
        return dist, s_, 1.0 - dist / 1.5

    def nov_now(p, n):
        return (torch.clamp(dot3(-p / torch.clamp_min(norm3(p, keepdim=True),
                                                      1e-6), n), 1e-3, 1.0),)

    # (the sun's radiance a plane: a constant factor XLA would fold)
    def shade_was(gn, d, sun, rad):
        n = gn * -torch.sign((gn * d).sum(-1, keepdim=True) + 1e-12)
        ndl = torch.clamp((n * sun).sum(-1), 0.0, 1.0)
        return (ndl, rad[..., 0] * ndl / np.pi)

    def shade_now(gn, d, sun, rad):
        n = gn * -torch.sign(dot3(gn, d)[..., None] + 1e-12)
        ndl = torch.clamp(dot3(n, sun), 0.0, 1.0)
        return (ndl, rad[..., 0] * ndl * recip(np.pi))

    def shade_jax(gn, d, sun, rad):
        n = gn * -jnp.sign(jnp.sum(gn * d, -1, keepdims=True) + 1e-12)
        ndl = jnp.clip(jnp.sum(n * sun, -1), 0.0, 1.0)
        return (ndl, rad[..., 0] * ndl / np.pi)

    def srgb_was(c):
        return (c @ torch.from_numpy(colorspace.SRGB_TO_AP1),)

    def delta_was(m, mp):
        return (torch.matmul(torch.linalg.inv(m), mp).reshape(-1, 16),)

    def delta_now(m, mp):
        return (shading.rigid_delta(m, mp).reshape(-1, 16),)

    def delta_jax(m, mp):
        return (jnp.einsum("oij,ojk->oik", jnp.linalg.inv(m), mp)
                .reshape(-1, 16),)

    def sumdot(a, b):
        return (a * b).sum(-1)

    return [
        ("ops/shading.py:206 motion delta inv(m) @ m_prev, as it was",
         ("mats", "mats_prev"), delta_was, delta_jax),
        ("ops/shading.py:206 motion delta, now (rigid_delta)",
         ("mats", "mats_prev"), delta_now, delta_jax),
        ("ops/colorspace.py:38 srgb_to_acescg, as it was", ("dirs",),
         srgb_was, lambda c: (jcs.srgb_to_acescg(c),)),
        ("ops/colorspace.py:38 srgb_to_acescg, now", ("dirs",),
         lambda c: (colorspace.srgb_to_acescg(c),),
         lambda c: (jcs.srgb_to_acescg(c),)),
        ("ops/gi.py:258 ssao tap (dist, s, radius factor), as it was",
         ("pos", "nrm"), ssao_was, ssao_jax),
        ("ops/gi.py:258 ssao tap (dist, s, radius factor), now",
         ("pos", "nrm"), ssao_now, ssao_jax),
        ("ops/ddgi.py:359 probe (dist_tp, wrap dot), as it was",
         ("pos2", "pos", "nrm"), probe_port(vnorm, sumdot), probe_jax),
        ("ops/ddgi.py:359 probe (dist_tp, wrap dot), now",
         ("pos2", "pos", "nrm"), probe_port(norm3, dot3), probe_jax),
        ("ops/screen_probe.py:263 taps (dist, cosn), as it was",
         ("pos", "nrm"), taps_port(vnorm, sumdot), taps_jax),
        ("ops/screen_probe.py:263 taps (dist, cosn), now", ("pos", "nrm"),
         taps_port(norm3, dot3), taps_jax),
        ("ops/screen_probe.py:532 _edge_weight (nf, df, w), as it was",
         ("pos", "pos2", "nrm", "nrm_i"), edge_port, edge_jax),
        ("ops/screen_probe.py _edge_weight (nf, nf * df, w), now",
         ("pos", "pos_near", "nrm", "nrm_near"), edge_now, edge_jax_parts),
        ("ops/rt.py:546 shade_hits (ndl, ndl / pi), as it was",
         ("nrm_i", "dirs", "sun", "pos"), shade_was, shade_jax),
        ("ops/rt.py:546 shade_hits (ndl, ndl / pi), now",
         ("nrm_i", "dirs", "sun", "pos"), shade_now, shade_jax),
        ("ops/shading.py:135 resolve normal, as it was", ("nrm_i",),
         unit_port(vnorm, 1e-8), unit_jax(1e-8)),
        ("ops/shading.py:135 resolve normal, now", ("nrm_i",),
         unit_port(norm3, 1e-8), unit_jax(1e-8)),
        ("ops/shading.py:418 _norm3, as it was", ("dirs",), norm3_port,
         lambda x: (jn(x, axis=-1, keepdims=True),)),
        ("ops/shading.py _norm3, now", ("dirs",),
         lambda x: (shading._norm3(x),),
         lambda x: (jn(x, axis=-1, keepdims=True),)),
        ("ops/ssr.py:46 view, reflection, as it was", ("pos", "nrm"),
         ssr_port(vnorm, sumdot), ssr_jax),
        ("ops/ssr.py:46 view, reflection, now", ("pos", "nrm"),
         ssr_port(norm3, dot3), ssr_jax),
        ("ops/ssr.py:83 toward_cam, as it was", ("pos", "nrm"), toward_was,
         toward_jax),
        ("ops/ssr.py:83 toward_cam, now", ("pos", "nrm"), toward_now,
         toward_jax),
        ("ops/atmosphere.py:279 sample_sky direction, as it was",
         ("dirs",), unit_port(vnorm, 1e-8), unit_jax(1e-8)),
        ("ops/atmosphere.py:279 sample_sky direction, now", ("dirs",),
         unit_port(norm3, 1e-8), unit_jax(1e-8)),
        ("renderer/meshlet_frame.py:163 pixel_view_dirs, as it was",
         ("dirs",), unit_port(vnorm, 1e-8), unit_jax(1e-8)),
        ("renderer/meshlet_frame.py:163 pixel_view_dirs, now", ("dirs",),
         unit_port(norm3, 1e-8), unit_jax(1e-8)),
        ("renderer/meshlet_frame.py:538 _aerial dist, as it was", ("pos",),
         lambda p: (vnorm(p),), lambda p: (jn(p, axis=-1),)),
        ("renderer/meshlet_frame.py:538 _aerial dist, now", ("pos",),
         lambda p: (norm3(p),), lambda p: (jn(p, axis=-1),)),
        ("renderer/meshlet_frame.py:706 specular nov, as it was",
         ("pos", "nrm"), nov_port, nov_jax),
        ("renderer/meshlet_frame.py:706 specular nov, now", ("pos", "nrm"),
         nov_now, nov_jax),
    ]


def sites(h: int = 64, w: int = 128) -> None:
    import jax
    import torch

    x = _site_inputs(h, w)
    for name, keys, port, jfn in _sites():
        args = [x[k] for k in keys]
        got = port(*(torch.from_numpy(a) for a in args))
        want = jax.jit(jfn)(*args)
        parts = []
        for g, j in zip(got, want):
            g, j = g.numpy(), np.asarray(j)
            off = (g != j).any(-1) if g.ndim == 3 and g.shape[-1] > 1 \
                else g != j
            parts.append(f"{int(off.sum())} of {off.size} "
                         f"({off.sum() / off.size:.4%})")
        print(f"{name}: elements that differ from chord_tpu's jitted "
              f"value {'; '.join(parts)}", flush=True)


_LIBM_BATCH = r"""
#include <math.h>
void libm_sincosf(const float* x, float* s, float* c, long n) {
  for (long i = 0; i < n; ++i) { s[i] = sinf(x[i]); c[i] = cosf(x[i]); }
}
void libm_powf(const float* x, float y, float* out, long n) {
  for (long i = 0; i < n; ++i) out[i] = powf(x[i], y);
}
"""


def _libm():
    """The C library's batch helpers, compiled with `cc` into a temporary
    directory -> (ctypes library, the directory's cleanup)."""
    import ctypes
    import subprocess
    import tempfile

    tmp = tempfile.TemporaryDirectory()
    src, lib = os.path.join(tmp.name, "b.c"), os.path.join(tmp.name, "b.so")
    with open(src, "w") as f:
        f.write(_LIBM_BATCH)
    subprocess.run(["cc", "-O2", "-shared", "-fPIC", "-o", lib, src, "-lm"],
                   check=True)
    return ctypes.CDLL(lib), tmp


def powf(chunk: int = 1 << 24) -> None:
    import ctypes
    import time

    import jax
    import torch

    from chord_tpu_torch.ops import _util

    libm, tmp = _libm()
    libm.libm_powf.argtypes = [ctypes.c_void_p, ctypes.c_float,
                               ctypes.c_void_p, ctypes.c_long]

    def want(x, y):
        out = np.empty_like(x)
        libm.libm_powf(x.ctypes.data, y, out.ctypes.data, x.size)
        out[np.abs(out) < 2.0 ** -126] = 0.0      # XLA's FTZ
        out[np.abs(x) < 2.0 ** -126] = 0.0        # and DAZ
        return out

    def off(x, y):
        got = _util.powf_plain(torch.from_numpy(x), y).numpy()
        ref = want(x, y)
        return int(((got != ref) & ~(np.isnan(got) & np.isnan(ref))).sum())

    try:
        t0, n, bad = time.time(), 0, 0
        lo, hi = 0x00800000, 0x3F800000 + 1       # [2^-126, 1]
        for a in range(lo, hi, chunk):
            x = np.arange(a, min(a + chunk, hi), dtype=np.int32).view(F32)
            bad += off(x, 8.0)
            n += x.size
        print(f"powf_plain(x, 8) on every f32 in [2^-126, 1] ({n} values): "
              f"{bad} differ from the C library's powf (FTZ / DAZ); "
              f"{time.time() - t0:.0f} s", flush=True)
        rng = np.random.default_rng(11)
        x = np.concatenate([rng.random(1 << 20), rng.random(1 << 16) * 100,
                            rng.random(1 << 12) ** 30,
                            [0.0, 1.0, np.inf, np.nan, 1e-45, 2.0 ** -126]]
                           ).astype(F32)    # powf's domain: x >= 0
        for y in (0.5, 2.5, 3.3, 16.0):
            print(f"powf_plain(x, {y}) on {x.size} seeded inputs: "
                  f"{off(x, y)} differ", flush=True)
        xs = rng.random(1 << 20).astype(F32)
        jit = np.asarray(jax.jit(lambda v: v ** 8.0)(xs))
        got = _util.powf_plain(torch.from_numpy(xs), 8.0).numpy()
        print(f"jitted chord_tpu x ** 8.0 on {xs.size} seeded inputs in "
              f"[0, 1): {int((jit != got).sum())} differ from powf_plain",
              flush=True)
    finally:
        tmp.cleanup()


def trig(chunk: int = 1 << 23) -> None:
    import ctypes
    import subprocess
    import tempfile
    import time

    import torch

    from chord_tpu_torch.ops import _util

    with tempfile.TemporaryDirectory() as tmp:
        src, lib = os.path.join(tmp, "b.c"), os.path.join(tmp, "b.so")
        with open(src, "w") as f:
            f.write(_LIBM_BATCH)
        subprocess.run(["cc", "-O2", "-shared", "-fPIC", "-o", lib, src,
                        "-lm"], check=True)
        libm = ctypes.CDLL(lib)

        def want(x):
            s, c = np.empty_like(x), np.empty_like(x)
            libm.libm_sincosf(*(ctypes.c_void_p(a.ctypes.data)
                                for a in (x, s, c)), ctypes.c_long(x.size))
            return s, c

        def count(x):
            got = _util.sincosf_plain(torch.from_numpy(x))
            return sum(int((g.numpy().view(np.int32) != r.view(np.int32))
                           .sum()) for g, r in zip(got, want(x)))

        hpi = (_util._SC_HPI_HI, _util._SC_HPI_LO)
        t0, n, off, off_unfused = time.time(), 0, 0, 0
        for lo in range(0, 0x42F00000, chunk):     # up to 120.0f's bits
            bits = np.arange(lo, min(lo + chunk, 0x42F00000), dtype=np.int32)
            for sign in (0, np.int32(-2 ** 31)):
                x = (bits | sign).view(F32)
                off += count(x)
                # the reduction rounded twice: x - round(n * pi/2)
                _util._SC_HPI_HI, _util._SC_HPI_LO = hpi[0] + hpi[1], 0.0
                try:
                    off_unfused += count(x)
                finally:
                    _util._SC_HPI_HI, _util._SC_HPI_LO = hpi
                n += x.size
        print(f"sincosf_plain on every f32 in (-120, 120) ({n} values): "
              f"{off} sin or cos values differ from the C library's; with "
              f"the reduction rounded twice {off_unfused}; "
              f"{time.time() - t0:.0f} s", flush=True)


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else "order"
    {"order": order, "ddgi-frames": ddgi_frames, "directions": directions,
     "sites": sites, "trig": trig, "powf": powf}[mode]()
