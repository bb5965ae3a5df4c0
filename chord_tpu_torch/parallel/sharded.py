"""Strip-parallel frames on torch.distributed (port of
chord_tpu/parallel/sharded.py).

Sort-first screen-space parallelism: each rank of a process group owns
one horizontal strip of the image (strip 0 is the top) and runs the whole
frame for it (cull, raster, shade, post):

- the scene pools, instance tables, BVH and LUTs are replicated: every
  rank holds its own copy on its device;
- each rank's view is the full-frame projection composed with an
  off-centre crop that maps its strip's NDC y-range onto [-1, 1], so the
  strip frustum culls what lies outside the strip;
- the ranks exchange little: the 128-bin exposure histogram is averaged
  over the group inside the frame (auto-exposure sees the whole image),
  the world SH cache after each GI frame (each strip injects only its
  own probes), the frame's stats in one sum, and the strips of the image,
  gathered through host memory.

chord_tpu runs this as one shard_map program over a device mesh; the port
runs one process per strip. `spawn_strips` starts them on one host (the
CPU with gloo, or the cards), `ShardedRenderer` is what each rank drives,
`render_strips` is the rank function the tests and `dryrun` share.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import pickle
import queue
import tempfile
import time
import traceback
from dataclasses import replace
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..renderer.deferred import DeviceView, RendererConfig, render_frame_flat
from ..renderer.meshlet_frame import MeshletFrameConfig, render_frame_meshlet
from ..rhi.framebuffer import FrameHistory
from ..utils import math as cmath
from ..utils.camera import ViewUniform
from ..utils.collectives import (all_reduce_mean, all_reduce_sum,
                                 reduces_on_host)
from ..utils.device import resolve


def _strip_matrix(k: int, n: int) -> np.ndarray:
    """The row-vector matrix A (clip' = clip @ A) that maps strip k's NDC
    y-range [1-2k/n, 1-2(k+1)/n] onto [-1, 1] (NDC y is up: strip 0 is
    the top of the image)."""
    s = float(n)
    c = 1.0 - (2.0 * k + 1.0) / n     # the strip's centre in full-frame NDC
    a = np.eye(4, dtype=np.float64)
    a[1, 1] = s
    a[3, 1] = -c * s
    return a


def strip_uniform(u: ViewUniform, k: int, n: int) -> ViewUniform:
    """The full-frame view uniform cropped to strip k of n (float64
    products, then f32, as chord_tpu)."""
    a = _strip_matrix(k, n)
    crop = lambda m: np.float32(m.astype(np.float64) @ a)
    return replace(
        u, view_to_clip=crop(u.view_to_clip),
        translated_world_to_clip=crop(u.translated_world_to_clip),
        translated_world_to_clip_nojitter=crop(
            u.translated_world_to_clip_nojitter),
        prev_translated_world_to_clip_nojitter=crop(
            u.prev_translated_world_to_clip_nojitter),
        frustum_planes=np.float32(cmath.frustum_planes(
            u.translated_world_to_clip_nojitter.astype(np.float64) @ a)),
        render_size=(u.render_size[0], u.render_size[1] // n))


def strip_view(u: ViewUniform, k: int, n: int, device=None,
               **light_kwargs) -> DeviceView:
    """Rank k's DeviceView of n strips, on `device` (None = the card);
    `light_kwargs` go to DeviceView.from_uniform (sun, sky, shadow_cfg)."""
    return DeviceView.from_uniform(strip_uniform(u, k, n), device=device,
                                   **light_kwargs)


def strip_device_views(u: ViewUniform, n: int, device=None,
                       **light_kwargs) -> List[DeviceView]:
    """Every strip's DeviceView, strip 0 first (chord_tpu stacks them along
    a leading (n,) axis of its mesh)."""
    return [strip_view(u, k, n, device, **light_kwargs) for k in range(n)]


class ShardedRenderer:
    """One rank's driver of the strip-parallel frame (chord_tpu
    ShardedRenderer). `group` is the torch.distributed group whose ranks
    render the strips (None: the default group when one is initialised,
    else one strip on its own); rank k renders strip k. path="meshlet"
    runs the GPU-driven frame per strip (each rank culls against its
    strip's frustum), path="flat" the object-cull frame. Each rank keeps
    its own history; render() returns the whole image on every rank.

    As chord_tpu's, the strip frame runs at render size: the history has
    no post size, so a config with post_width / post_height set (the TSR
    upscale) is refused. There is no cascade warm-up (MeshletRenderer
    has one; chord_tpu's ShardedRenderer does not)."""

    def __init__(self, config: RendererConfig, group=None,
                 path: str = "flat", mcfg: Optional[MeshletFrameConfig] = None,
                 device=None):
        if path not in ("flat", "meshlet"):
            raise ValueError(f"path {path!r}: 'flat' or 'meshlet'")
        if config.post_width or config.post_height:
            raise ValueError(
                "ShardedRenderer renders at render size: the strips' "
                "history has no post size (as chord_tpu's), so "
                "post_width/post_height must be 0, not "
                f"{config.post_width}x{config.post_height}")
        if group is None and dist.is_initialized():
            group = dist.group.WORLD
        self.group = group
        self.n = dist.get_world_size(group) if group is not None else 1
        self.rank = dist.get_rank(group) if group is not None else 0
        if config.height % self.n:
            raise ValueError(f"height {config.height} is not divisible by "
                             f"{self.n} strips")
        # the image strips travel through host memory: gloo takes host
        # tensors on any backend's ranks
        self._host_group = None
        if group is not None:
            self._host_group = (group if reduces_on_host(group) else
                                dist.new_group(
                                    dist.get_process_group_ranks(group),
                                    backend="gloo"))
        self.device = resolve(device)
        self.config = config
        self.strip_config = config._replace(height=config.height // self.n)
        self.path = path
        self.mcfg = mcfg or MeshletFrameConfig()
        self.history: Optional[FrameHistory] = None

    def reset_history(self) -> None:
        self.history = None

    def _empty_history(self) -> FrameHistory:
        """chord_tpu's per-strip history: strip height, no post size,
        probe tile 8 with GI on."""
        from ..ops.gi import GIConfig

        m = self.mcfg
        return FrameHistory.empty(
            self.strip_config.height, self.config.width,
            gi_cfg=(m.gi_cfg or GIConfig()) if m.gi else None,
            shadow_cascades=m.shadow_cfg.cascade_count if m.shadows else 0,
            shadow_res=m.shadow_cfg.resolution if m.shadows else 1,
            shadow_div=m.shadow_cfg.eval_res_div,
            shadow_phase=(m.shadow_cfg.temporal_phase
                          if m.shadow_cfg.temporal else 1),
            probe_tile=8 if m.gi else 0, device=self.device)

    def render(self, pools, instances, view_uniform: ViewUniform, bvh=None,
               luts: Optional[dict] = None, **light_kwargs):
        """One frame of this rank's strip -> (image (H,W,3) u8 on the host,
        the whole image; stats summed over the strips). `luts` optionally
        holds the shared tables (atmo_t_lut, atmo_ms_lut, atmo_sky_lut,
        brdf_lut) on this rank's device. Every rank of the group calls
        it."""
        if self.history is None:
            self.history = self._empty_history()
        view = strip_view(view_uniform, self.rank, self.n, self.device,
                          **light_kwargs)
        if luts:
            view = view.replace(**luts)
        m = self.mcfg
        if self.path == "meshlet":
            fc = (int(self.history.frame_count) if m.shadows or m.gi
                  else None)
            image, hist, stats = render_frame_meshlet(
                pools, instances, view, self.history, self.strip_config, m,
                frame_index=fc, bvh=bvh, group=self.group)
            if m.gi and self.group is not None:
                # the world SH cache is world-anchored: each strip injected
                # only its own probes, so the ranks average theirs into one
                hist = hist.replace(
                    gi_cache=all_reduce_mean(hist.gi_cache, self.group))
        else:
            image, hist, stats = render_frame_flat(
                pools, instances, view, self.history, self.strip_config,
                group=self.group)
        self.history = hist
        if self.group is None:
            return image.cpu(), stats
        return self.gather(image), self.sum_stats(stats)

    def gather(self, strip: torch.Tensor) -> torch.Tensor:
        """This rank's image strip -> the whole (H,W,3) u8 image on the
        host, strip 0 on top (every rank gets it)."""
        strips = [torch.empty((self.strip_config.height, self.config.width,
                               3), dtype=torch.uint8)
                  for _ in range(self.n)]
        dist.all_gather(strips, strip.cpu(), group=self._host_group)
        return torch.cat(strips)

    def sum_stats(self, stats: dict) -> dict:
        """Each tensor stat summed over the group in one all-reduce of
        their float64 values (exact for the integer counts), back in its
        dtype and shape; other entries stay this rank's own."""
        keys = [k for k, v in stats.items() if isinstance(v, torch.Tensor)]
        if not keys:
            return dict(stats)
        total = all_reduce_sum(torch.cat(
            [stats[k].reshape(-1).to(torch.float64) for k in keys]),
            self.group)
        out, o = dict(stats), 0
        for k in keys:
            v = stats[k]
            out[k] = total[o:o + v.numel()].reshape(v.shape).to(v.dtype)
            o += v.numel()
        return out


# ---------------------------------------------------------------------------
# The launcher: one process per strip on this host.


def strip_backend(n: int, device=None):
    """-> (backend, device kind, reason): the rule spawn_strips follows.
    NCCL when each of the n ranks has a card of its own; gloo when the
    ranks run on the CPU or share cards (NCCL refuses two ranks on one
    GPU)."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo", "cpu", f"{n} ranks on the CPU"
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("spawn_strips: no CUDA device (pass "
                           "device='cpu' to run the strips on the CPU)")
    if cards >= n:
        return "nccl", "cuda", f"{n} ranks, each on a card of its own"
    return "gloo", "cuda", (f"{n} ranks share {cards} card(s): NCCL refuses "
                            "two ranks on one GPU")


def _strip_main(rank: int, n: int, backend: str, kind: str, store: str,
                timeout_s: float, threads: int, results, call: str) -> None:
    """A spawned rank: loads (fn, args) from the file `call`, joins the
    group, runs fn(rank, device, *args) and puts (rank, True, its result)
    or (rank, False, the traceback) on `results`."""
    try:
        with open(call, "rb") as f:
            fn, args = pickle.load(f)
        # every rank is on this host
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        if kind == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        else:
            device = torch.device("cpu")
            torch.set_num_threads(threads)
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=n, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, device, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_strips(n: int, fn: Callable, *args, device=None,
                 backend: Optional[str] = None,
                 timeout_s: float = 600.0) -> list:
    """Run fn(rank, device, *args) in n spawned processes that form the
    default process group (rendezvous through a FileStore in a temporary
    directory: no TCP port to collide) -> [rank 0's result, ...].

    `device` None puts the ranks on the cards, "cpu" on the CPU; the
    backend follows strip_backend's rule (printed) unless `backend` names
    one. `fn` must be picklable by reference (a module-level function of
    a module the ranks can import). (fn, args) go to the ranks through a
    file in the temporary directory, not the spawn pipe: a scene's pools
    are large, and a rank that dies before it reads the pipe would leave
    the writer blocked. The group's set-up and the whole run have a
    deadline of `timeout_s`: a rank that raises, dies or overruns it
    fails the call (RuntimeError with the rank's traceback, or
    TimeoutError), and every rank still running is killed."""
    import multiprocessing as mp

    rule, kind, reason = strip_backend(n, device)
    backend = backend or rule
    print(f"spawn_strips: {n} ranks, backend {backend} ({reason})",
          flush=True)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    threads = max(1, torch.get_num_threads() // n)
    with tempfile.TemporaryDirectory(prefix="strips_") as tmp:
        store = os.path.join(tmp, "store")
        call = os.path.join(tmp, "call.pkl")
        with open(call, "wb") as f:
            pickle.dump((fn, args), f, protocol=pickle.HIGHEST_PROTOCOL)
        procs = [ctx.Process(target=_strip_main, daemon=True,
                             args=(r, n, backend, kind, store, timeout_s,
                                   threads, results, call))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        out = {}
        try:
            while len(out) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"spawn_strips: ranks {sorted(set(range(n)) - set(out))}"
                        f" did not finish within {timeout_s} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(
                            f"spawn_strips: rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                    continue
                if not ok:
                    raise RuntimeError(
                        f"spawn_strips: rank {rank} raised:\n{payload}")
                out[rank] = payload
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
                if p.exitcode is None:
                    raise TimeoutError("spawn_strips: a rank did not exit "
                                       f"within {timeout_s} s")
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.kill()
                    p.join(10)
            results.close()
    return [out[r] for r in range(n)]


# ---------------------------------------------------------------------------
# The rank function of the tests and dryrun.


class StripJob(NamedTuple):
    """A strip-parallel run, every array as numpy so the ranks rebuild it
    on their own device. `instances` is one table for every frame or one
    per frame; `pools`, `instances`, `bvh` are mappings of arrays
    (interop's inputs), `luts` maps DeviceView LUT names to arrays."""

    path: str
    config: RendererConfig
    mcfg: Optional[MeshletFrameConfig]
    pools: dict
    instances: object
    uniforms: Sequence[ViewUniform]
    bvh: Optional[dict] = None
    luts: Optional[dict] = None
    light_kwargs: Optional[dict] = None


def load_job(job: StripJob, device):
    """-> (pools, [instances per frame], bvh, luts) on `device`."""
    from .. import interop

    pools = (interop.pools_from_numpy(job.pools, device) if
             job.path == "meshlet" else
             interop.scene_pools_from_numpy(job.pools, device))
    insts = job.instances
    if isinstance(insts, dict):
        insts = [insts] * len(job.uniforms)
    insts = [interop.instances_from_numpy(i, device) for i in insts]
    bvh = (interop.bvh_from_numpy(job.bvh, device) if job.bvh is not None
           else None)
    luts = ({k: torch.from_numpy(np.array(v)).to(device)
             for k, v in job.luts.items()} if job.luts else None)
    return pools, insts, bvh, luts


def digest(t: torch.Tensor) -> str:
    """SHA-256 of a tensor's bytes (bit-equality across ranks)."""
    return hashlib.sha256(t.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()


def render_strips(rank: int, device, job: StripJob) -> List[dict]:
    """Every frame of `job` through ShardedRenderer on the default group
    -> per frame {image (H,W,3) u8 numpy (rank 0; None elsewhere), stats
    (numpy), exposure, gi_cache digest}."""
    r = ShardedRenderer(job.config, path=job.path, mcfg=job.mcfg,
                        device=device)
    pools, insts, bvh, luts = load_job(job, device)
    frames = []
    for u, inst in zip(job.uniforms, insts):
        image, stats = r.render(pools, inst, u, bvh=bvh, luts=luts,
                                **(job.light_kwargs or {}))
        frames.append(dict(
            image=image.numpy() if rank == 0 else None,
            stats={k: v.cpu().numpy() for k, v in stats.items()
                   if isinstance(v, torch.Tensor)},
            exposure=float(r.history.exposure),
            gi_cache=digest(r.history.gi_cache)))
    return frames


def dryrun_job(n_devices: int, frames: int = 1) -> StripJob:
    """chord_tpu's dry-run configuration (its `dryrun`, and its
    test_sharded_full_feature_frame): the full feature set (GPU-driven
    cull, Nanite LOD, two-phase occlusion, textures, masked and blend
    buckets, cascaded shadows, atmosphere, screen-probe GI, BVH rays, SSR,
    bloom, global TSR) on the small textured bistro at 128 x 16n, the
    first `frames` frames of a still camera; the scene built on the host."""
    from .. import interop
    from ..asset.procedural import build_bistro_like
    from ..ops import atmosphere as atm
    from ..ops import brdf_lut as brdf
    from ..ops.rt import build_scene_bvh
    from ..ops.screen_probe import ScreenProbeConfig
    from ..ops.shadow import ShadowConfig
    from ..rhi.meshlet_scene import build_meshlet_pools
    from ..utils.camera import Camera

    b = build_bistro_like(detail=1, target_tris=12_000, textures=True)
    pools = build_meshlet_pools(b, texture_pool=getattr(b, "texture_pool",
                                                        None), device="cpu")
    h = 16 * n_devices
    cam = Camera(width=128, height=h)
    cam.position = np.array([-20.0, 5.0, 4.0])
    cam.look_at(np.array([25.0, 3.0, -4.0]))
    scfg = ShadowConfig(cascade_count=2, resolution=64, temporal=False,
                        jitter=False)
    mcfg = MeshletFrameConfig(
        draw_capacity=128, occlusion=True, shadows=True, shadow_cfg=scfg,
        atmosphere=True, gi=True, gi_mode="probe", gi_rt=True, rt_rays=2,
        ssr=True, textured=True, alpha_masked=True, alpha_blend=True,
        probe_cfg=ScreenProbeConfig(rays=16, steps=4))
    config = RendererConfig(width=128, height=h, pair_capacity=2048,
                            big_capacity=128, enable_bloom=True,
                            enable_tsr=True, tsr_mode="global")
    inst = b.frame_instances(cam, device="cpu")
    bvh = build_scene_bvh(pools, inst, granularity="object")
    p_atm = atm.AtmosphereParams()
    t_lut = atm.build_transmittance_lut(p_atm, 16, device="cpu")
    ms_lut = atm.build_multiscatter_lut(p_atm, t_lut, dir_samples=4, steps=4)
    sun_d = np.asarray([0.3, 0.8, 0.5], np.float32)
    sun_d /= np.linalg.norm(sun_d)
    sky_lut = atm.build_sky_view_lut(p_atm, t_lut, ms_lut,
                                     torch.from_numpy(sun_d))
    luts = dict(atmo_t_lut=t_lut, atmo_ms_lut=ms_lut, atmo_sky_lut=sky_lut,
                brdf_lut=brdf.build_env_brdf_lut(16, device="cpu"))
    return StripJob(
        "meshlet", config, mcfg, interop.to_numpy(pools),
        interop.to_numpy(inst), [cam.view_uniform(i) for i in range(frames)],
        bvh=interop.to_numpy(bvh),
        luts={k: v.numpy() for k, v in luts.items()},
        light_kwargs=dict(shadow_cfg=scfg))


def dryrun(n_devices: int, device=None) -> None:
    """chord_tpu's multi-device dry run: one frame of dryrun_job on
    n_devices ranks (`device` None = the cards), the exposure histogram
    and the world SH cache averaged over them. Prints chord_tpu's line."""
    job = dryrun_job(n_devices)
    frame = spawn_strips(n_devices, render_strips, job, device=device)[0][0]
    stats = {k: v.item() for k, v in frame["stats"].items()}
    print(f"dryrun_multichip({n_devices}): image "
          f"{tuple(frame['image'].shape)}, stats {stats}")
