"""One-off CPU probes of how the port's ray sets and ray tests round
against chord_tpu's compiled ones (not tests: the tier-1 run's XLA keeps
FMA, these compile chord_tpu without it, as the bench goldens are).

    python tests/ray_order_probe.py order        # ~10 s
    python tests/ray_order_probe.py ddgi-frames  # ~10 s
    python tests/ray_order_probe.py directions   # ~1 min

`order`: chord_tpu's jitted _ray_sphere, trace_dense_tri and trace_bvh
(over a triangle and a sphere BVH, at the default budget and a short one)
against the numpy f32 oracles of tests/test_torch_ray_rounding.py (each
3-term dot summed (p0 + p1) + p2), and a size-3 jnp.sum against both
association orders: which order XLA's CPU build uses.

`ddgi-frames`: frames 0-63 on which the port's ddgi.ray_table (and
screen_probe.ray_table) differs from chord_tpu's jitted
`fib @ _jitter_rotation(f).T`, and those of them on which XLA's f32 cos or
sin of the frame's angles differs from the f64 value rounded to f32.

`directions`: RTAO's per-pixel ray directions (ops/gi.py rtao: device cos
and sin of the IGN azimuth) and the specular GI's GGX reflection
directions (ops/screen_probe.py ggx_sample_normal, the frame's
2 (v.h) h - v) at 128x64 over frames 0-7, each package with its own noise
(the port's eager IGN, chord_tpu's jitted one), on seeded surface points
of a triangle soup: the share of rays whose direction differs from
chord_tpu's, and the share whose trace result (t bits or leaf; each
package's own trace of its own rays over the same BVH) then differs.

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

    from chord_tpu.ops import ddgi as jd
    from chord_tpu.ops import screen_probe as jsp
    from chord_tpu_torch.ops import ddgi
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
            ang = (x * F32(2.3999632297286533), x * F32(tilt))
            host = np.array([np.cos(np.float64(ang[0])),
                             np.sin(np.float64(ang[0])),
                             np.cos(np.float64(ang[1])),
                             np.sin(np.float64(ang[1]))]).astype(F32)
            t = np.asarray(xla_trig(jnp.int32(f)))
            if (t != host).any():
                trig_off[f] = [("cos a", "sin a", "cos b", "sin b")[k]
                               for k in range(4) if t[k] != host[k]]
        print(f"{name} ({size} components a frame): differs from "
              f"chord_tpu's jitted rotation on frames {off} ({comps} of "
              f"{64 * size} components); XLA's f32 cos / sin differ from "
              f"the f64 value rounded on frames {trig_off}", flush=True)


def directions(frames: int = 8, h: int = 64, w: int = 128) -> None:
    import jax
    import jax.numpy as jnp
    import torch

    from chord_tpu.ops import bluenoise as jbn
    from chord_tpu.ops import gi as jgi
    from chord_tpu.ops import rt as jrt
    from chord_tpu.ops import screen_probe as jsp
    from chord_tpu_torch.ops import gi, rt
    from chord_tpu_torch.ops import screen_probe as sp
    from chord_tpu_torch.ops.bluenoise import interleaved_gradient_noise
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
    view = (cam - pos) / np.linalg.norm(cam - pos, axis=-1, keepdims=True)
    view = view.astype(F32)
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

    def j_ggx(n, v, r, fc):
        u1 = jbn.interleaved_gradient_noise(h, w, fc)
        u2 = jbn.interleaved_gradient_noise(h, w, fc + 31)
        hh = jsp.ggx_sample_normal(n, v, r, u1, u2)
        return 2.0 * jnp.sum(v * hh, -1, keepdims=True) * hh - v

    jrt.trace = spy(jcalls, jtrace)
    try:
        rtao_j = jax.jit(j_rtao)
        ggx_j = jax.jit(j_ggx)
        trace_j = jax.jit(lambda o, d, b, tm: jtrace(o, d, b, t_max=tm))
        tot = {k: np.zeros(3, np.int64) for k in ("rtao", "ggx")}
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
            u1 = interleaved_gradient_noise(h, w, f, device="cpu")
            u2 = interleaved_gradient_noise(h, w, f + 31, device="cpu")
            v_t = torch.from_numpy(view)
            hh = sp.ggx_sample_normal(torch.from_numpy(nrm), v_t,
                                      torch.from_numpy(rough), u1, u2)
            refl = 2.0 * (v_t * hh).sum(-1, keepdim=True) * hh - v_t
            pairs.append(("ggx", np.asarray(ggx_j(nrm, view, rough, fc)),
                          refl.numpy(), 1e9))
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
    finally:
        jrt.trace = jtrace


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else "order"
    {"order": order, "ddgi-frames": ddgi_frames,
     "directions": directions}[mode]()
