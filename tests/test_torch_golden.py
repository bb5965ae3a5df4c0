"""The port's frames held to chord_tpu's golden images.

tests/goldens/sponza_{basic,normal,full}_160x96.png are chord_tpu's own
renders (tests/test_golden.py:60-87): build_sponza_like(detail=1) at
160x96 through MeshletRenderer, pair capacity 4096, big capacity 128,
draw_capacity=512, no TSR; `basic` and `normal` without occlusion,
`normal` as the normal debug view, `full` with two-phase occlusion,
ShadowConfig()'s four 1024² cascades (the renderer's warm-up fills them
before the presented frame) and bloom. The port renders the same configs
on the CPU (the kernels' plain versions) and is held to the PNGs with
chord_tpu's own gates (tests/test_golden.py:104-112): global SSIM >= 0.99,
mean absolute error < 2 levels, worst 16x16 window SSIM >= 0.95. The PNGs
are only read.
"""

from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from chord_tpu_torch.asset.procedural import build_sponza_like
from chord_tpu_torch.renderer import (MeshletFrameConfig, MeshletRenderer,
                                      RendererConfig)
from chord_tpu_torch.rhi.meshlet_scene import build_meshlet_pools
from chord_tpu_torch.utils.camera import Camera
from test_golden import ssim, windowed_ssim

GOLDEN_DIR = Path(__file__).parent / "goldens"


def render_golden_config(mode: str, device) -> np.ndarray:
    """tests/test_golden.py's scene and config of `mode`, rendered by the
    port on `device` -> (96, 160, 3) u8."""
    b = build_sponza_like(detail=1)
    pools = build_meshlet_pools(b, device=device)
    cam = Camera(width=160, height=96)
    cam.position = np.array([-15.0, 4.0, 3.0])
    cam.look_at(np.array([10.0, 2.0, -2.0]))
    r = MeshletRenderer(
        RendererConfig(width=160, height=96, pair_capacity=4096,
                       big_capacity=128, enable_bloom=(mode == "full"),
                       enable_tsr=False),
        MeshletFrameConfig(draw_capacity=512, occlusion=(mode == "full"),
                           shadows=(mode == "full"),
                           debug_mode="normal" if mode == "normal" else
                           "none"))
    img, stats = r.render(pools, b.frame_instances(cam, device=device),
                          cam.view_uniform(0))
    assert int(stats["bin_overflow"]) == 0
    return img.cpu().numpy()


@pytest.mark.parametrize("mode", ["basic", "normal", "full"])
def test_port_matches_golden(mode):
    img = render_golden_config(mode, "cpu")
    golden = np.asarray(Image.open(GOLDEN_DIR / f"sponza_{mode}_160x96.png"))
    assert img.shape == golden.shape == (96, 160, 3)
    s = ssim(img, golden)
    mae = np.abs(img.astype(int) - golden.astype(int)).mean()
    ws = windowed_ssim(img, golden)
    assert s >= 0.99, f"SSIM {s:.4f} < 0.99 for {mode}"
    assert mae < 2.0, f"MAE {mae:.2f} too high for {mode}"
    assert ws >= 0.95, f"worst-window SSIM {ws:.4f} < 0.95 for {mode}"


@pytest.mark.parametrize("mode", ["basic", "normal", "full"])
def test_chip_smoke_golden_helpers_match(mode, monkeypatch):
    """chip_smoke.py's own PNG reader (the path it takes on a machine
    without PIL) reads each golden as PIL does, and its copies of the SSIM
    gates equal tests/test_golden.py's on the golden against a perturbed
    copy."""
    import sys

    import chip_smoke

    path = GOLDEN_DIR / f"sponza_{mode}_160x96.png"
    want = np.asarray(Image.open(path))
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = chip_smoke.read_png(str(path))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(31)
    other = np.clip(want.astype(int) + rng.integers(-9, 10, want.shape), 0,
                    255).astype(np.uint8)
    assert chip_smoke.ssim(want, other) == ssim(want, other) < 1.0
    assert chip_smoke.windowed_ssim(want, other) == windowed_ssim(want,
                                                                  other)
