"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked `cuda`: each test skips where torch sees no CUDA device (the CPU
test runs); on the GPU machine run them with

    python -m pytest tests/test_torch_cuda.py -q

Tolerance: 0. The kernels are built with -fmad=false and round every
product and sum as the plain versions do, so every output must match bit
for bit (integer outputs exactly; float outputs bit for bit, NaN where
NaN).
"""

import numpy as np
import pytest
import torch

from chord_tpu_torch.asset.procedural import build_sponza_like
from chord_tpu_torch.ops import kernels, raster, row_gather, tile_reproject
from chord_tpu_torch.renderer import (DeviceView, MeshletFrameConfig,
                                      RendererConfig,
                                      render_sequence_meshlet)
from chord_tpu_torch.rhi.framebuffer import FrameHistory
from chord_tpu_torch.rhi.meshlet_scene import build_meshlet_pools
from chord_tpu_torch.utils.camera import Camera

W, H, PW, PH = 128, 64, 192, 96
CFG = RendererConfig(width=W, height=H, post_width=PW, post_height=PH,
                     pair_capacity=4096, big_capacity=128, tsr_mode="tile")
MCFG = MeshletFrameConfig(draw_capacity=1024)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run on the GPU)")
    return torch.device("cuda", 0)


def _sequence(d, frames=3):
    b = build_sponza_like(detail=1)
    cam = Camera(width=W, height=H)
    cam.position = np.array([-15.0, 4.0, 0.0])
    cam.look_at(np.array([10.0, 2.0, 0.0]))
    vs = []
    for i in range(frames):
        cam.position = np.array([-15.0 + 0.5 * i, 4.0, 0.3 * i])
        vs.append(DeviceView.from_uniform(cam.view_uniform(i, jitter=True),
                                          device=d))
    return (build_meshlet_pools(b, device=d), b.frame_instances(cam, device=d),
            DeviceView.stack(vs), FrameHistory.empty(H, W, PH, PW, device=d))


def _exact(k, args, kwargs):
    got = kernels.outputs_list(k.fn()(*args, **kwargs))
    ref = kernels.outputs_list(k.plain(*args, **kwargs))
    torch.cuda.synchronize()
    assert kernels.max_abs_err(got, ref) == 0.0, k.name


@pytest.mark.cuda
def test_kernels_match_plain_on_frame_inputs(dev):
    pools, inst, views, hist = _sequence(dev)
    kernels.reset_launch_counts()
    with kernels.capture_inputs() as captured:
        render_sequence_meshlet(pools, inst, views, hist, CFG, MCFG)
    counts = kernels.launch_counts()
    for k in kernels.KERNELS:
        assert captured[k.name], k.name
        assert counts[k.name] == len(captured[k.name]), k.name
        for args, kwargs in captured[k.name]:
            _exact(k, args, kwargs)


@pytest.mark.cuda
def test_raster_variants_match_plain(dev):
    """z_clip and depth-only rasters (not on the `off` path)."""
    pools, inst, views, hist = _sequence(dev, frames=1)
    with kernels.capture_inputs() as captured:
        render_sequence_meshlet(pools, inst, views, hist, CFG, MCFG)
    k = kernels.KERNELS[0]
    args, _ = captured["raster"][-1]
    pair_win, starts, counts, sb, coefT, seeds, _z, c = args
    zclip = torch.where(seeds[0] > 0, seeds[0] * 1.0001,
                        torch.full_like(seeds[0], 3e38))
    _exact(k, (pair_win, starts, counts, sb, coefT, seeds, zclip,
               c._replace(z_clip=True)), {})
    _exact(k, (pair_win, starts, counts, sb, coefT, seeds[:2], None,
               c._replace(with_attrs=False)), {})


@pytest.mark.cuda
def test_gather_and_reproject_random_inputs(dev):
    rng = np.random.default_rng(0)
    n = 2560
    table = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, (16, n),
                                          dtype=np.int64).astype(np.int32))
    slot = torch.from_numpy(rng.integers(-5, n + 50, (720, 1280),
                                         dtype=np.int64).astype(np.int32))
    got = row_gather.gather_rows(table.to(dev), slot.to(dev))
    assert torch.equal(got.cpu(), row_gather.gather_rows_plain(table, slot))

    img = torch.from_numpy(rng.uniform(0, 2, (1080, 1920, 3)).astype(
        np.float32))
    mot = torch.from_numpy(rng.normal(0, 20, (1080, 1920, 2)).astype(
        np.float32))
    with kernels.capture_inputs() as captured:
        tile_reproject.tile_reproject(img.to(dev), mot.to(dev))
    args, kwargs = captured["tile_reproject"][0]
    _exact(kernels.KERNELS[3], args, kwargs)


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(dev):
    table = torch.zeros((16, 8), dtype=torch.float32, device=dev)
    slot = torch.zeros((4, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        row_gather.gather_rows(table, slot)
    with pytest.raises(ValueError):
        tile_reproject.reproject_tiles(
            torch.zeros((3, 10, 10), device=dev),
            torch.zeros((1, 4), dtype=torch.int32, device=dev), 32, 128)
    with pytest.raises(NotImplementedError):
        raster.raster_queue(None, raster.TriangleSetup(
            coefT=table, window_bbox=slot, window_valid=slot, valid=slot),
            raster.RasterConfig(width=8, height=8, bricks=True))


@pytest.mark.cuda
def test_gpu_frames_match_cpu_plain(dev):
    """The tiny sequence through the kernels on the GPU equals the plain
    versions on the CPU (the path the CPU tests hold against chord_tpu):
    stats exactly, images within 2 u8 levels on >= 99.9% of values."""
    out = {}
    for d in (dev, torch.device("cpu")):
        imgs, _, st = render_sequence_meshlet(*_sequence(d), CFG, MCFG,
                                              with_stats=True)
        out[d.type] = (imgs.cpu().numpy().astype(np.int32),
                       {k: v.cpu().tolist() for k, v in st.items()})
    assert out["cuda"][1] == out["cpu"][1]
    diff = np.abs(out["cuda"][0] - out["cpu"][0])
    assert (diff <= 2).mean() >= 0.999, diff.max()
