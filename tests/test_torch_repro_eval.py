"""The port's repro_eval_kernel tool against chord_tpu's
tools/repro_eval_kernel.py, variant by variant, at the tool's bench shapes
(1080p: eval grid 270x480, phase 2 at 135x240, 4 x 1024^2 maps).

chord_tpu's tool runs unchanged: its main() with sys.argv patched, and
jax.device_get patched to keep the first result (frame index 1) and stop
before the timing loop. The port's variant is built with build(variant,
"cpu") and called at frame 1 on the same seeded inputs.

Tolerances, with their reasons:
- Variants without evaluate_shadow (gather, frame_gather, t_*) and the
  blend of tm_hist (last frame's q is zeros): every element within 1e-5
  (measured: gathers exact, the blend's exp within 1.2e-7).
- Every variant that runs evaluate_shadow: >= 99.9% of elements within
  1e-5, every element within one PCF sample (1/6), as
  tests/test_torch_shadow.py holds evaluate_shadow: the receivers'
  light-space coordinates round differently under XLA's FMAs, which can
  move a tap across a texel edge (measured on eval_noign: 1 pixel of
  32,400). The IGN noise is one such FMA: chord_tpu's tool jits its run,
  and XLA contracts the noise's 0.06711056*x + 0.00583715*y, so the
  rotation angle moves by up to 1.03e-4 at ~23% of pixels (eager JAX
  equals the port bit for bit), and a rotated tap that crosses a texel
  edge flips a blocker, which moves every PCF tap of the pixel. So the
  port's tool is fed chord_tpu's jitted noise for the same (h, w, frame)
  in these tests; test_eval_difference_is_the_jitted_noise shows that the
  port's own noise is the eager one.
  Measured with it: 1 to 4 elements per output beyond 1e-5 (0.006%).
- The temporal blend's output (temporal, tm_barrier, tm_pallas, tm_copy,
  tm_dual, tm_split): the same fraction, and every element within 1/6
  times the blend's largest slope in q, 1 + 0.7/e^2 (the blend is
  sq + (prev - sq) * 0.7 * exp(-4 |prev - sq|)): a flipped tap moves q by
  1/6 and the blend may stretch that (measured: 0.174).
- scan_eval, scan_eval_nocarry (two means of 32,400 pixels): within 1e-4
  relative (measured: 5.1e-6 absolute, one pixel's 1/6 over 32,400).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tools.repro_eval_kernel as jtool
from chord_tpu.ops import shadow as jshadow
from chord_tpu.ops.bluenoise import interleaved_gradient_noise as jax_ign

from chord_tpu_torch.ops import kernels, shadow
from chord_tpu_torch.ops.bluenoise import interleaved_gradient_noise
from chord_tpu_torch.tools import repro_eval_kernel as tool

NO_EVAL = {"gather", "frame_gather", "t_roll", "t_up", "t_uproll",
           "t_gather2d", "t_blend", "t_gatherflat"}
BLEND = {"temporal", "tm_barrier", "tm_pallas", "tm_copy", "tm_dual",
         "tm_split"}                    # output 0 is the temporal blend
PCF_TAP = 1 / 6
BLEND_SLOPE = 1 + 0.7 * np.exp(-2.0)    # max of d(blend)/d(sq)


class _Stop(Exception):
    pass


def _reference(monkeypatch, variant):
    """chord_tpu's tool, unchanged, up to its first device_get."""
    got = []
    device_get = jax.device_get

    def first(x):
        got.append(device_get(x))
        raise _Stop

    monkeypatch.setattr(sys, "argv", ["repro_eval_kernel.py", variant])
    monkeypatch.setattr(jax, "device_get", first)
    with pytest.raises(_Stop):
        jtool.main()
    monkeypatch.undo()
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(got[0])]


def _jitted_noise(monkeypatch):
    """Feed the port's tool chord_tpu's noise as its jitted run computes
    it (frame index traced)."""
    jitted = {}

    def noise(h, w, fc, device=None):
        if (h, w) not in jitted:
            jitted[h, w] = jax.jit(lambda f: jax_ign(h, w, f))
        z = np.array(jitted[h, w](jnp.int32(int(fc))))
        return torch.from_numpy(z).to(device)

    monkeypatch.setattr(tool, "interleaved_gradient_noise", noise)


def _port(variant):
    run, args = tool.build(variant, "cpu")
    extra = ((torch.zeros((tool.HP, tool.WP)),) if variant == "tm_hist"
             else ())
    out = run(*args, 1, *extra)
    return [a.numpy() for a in (out if isinstance(out, tuple) else (out,))]


def test_variants_are_the_reference_tools():
    assert set(tool.VARIANTS) == jtool.VARIANTS
    assert len(tool.VARIANTS) == 22


@pytest.mark.parametrize("variant", tool.VARIANTS)
def test_variant_matches(monkeypatch, variant):
    ref = _reference(monkeypatch, variant)
    _jitted_noise(monkeypatch)
    got = _port(variant)
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        d = np.abs(a.astype(np.float64) - b)
        if variant in NO_EVAL or (variant == "tm_hist" and i == 0):
            assert d.max() <= 1e-5, (i, d.max())
        elif variant.startswith("scan_"):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=0)
        else:
            assert (d <= 1e-5).mean() >= 0.999, (i, (d > 1e-5).sum())
            tap = PCF_TAP * (BLEND_SLOPE if variant in BLEND and i == 0
                             else 1.0)
            assert d.max() <= tap + 1e-6, (i, d.max())


def test_eval_difference_is_the_jitted_noise():
    """The noise under chord_tpu's jit differs from the port's (an FMA);
    eager it is equal; fed the jitted noise, the port's evaluate_shadow
    meets the no-noise tolerance on the `eval` variant's inputs."""
    h, w = tool.HP, tool.WP
    port = interleaved_gradient_noise(h, w, 1, device="cpu").numpy()
    eager = np.asarray(jax_ign(h, w, 1))
    jitted = np.array(jax.jit(lambda f: jax_ign(h, w, f))(jnp.int32(1)))
    np.testing.assert_array_equal(eager, port)
    assert 0.0 < np.abs(jitted - port).max() <= 2e-4

    _, (pos, nrm, maps, mats) = tool.build("eval", "cpu")
    sun = np.asarray([0.3, 0.8, 0.5], np.float32)
    sun = sun / np.sqrt(np.sum(sun * sun))
    scfg = tool.SCFG
    ref = np.asarray(jax.jit(
        lambda p, n, m, t, z: jshadow.evaluate_shadow(
            p, n, jnp.asarray(sun), m, t, jshadow.ShadowConfig(), noise=z))(
        pos.numpy(), nrm.numpy(), maps.numpy(), mats.numpy(), jitted))
    got = shadow.evaluate_shadow(pos, nrm, torch.from_numpy(sun), maps, mats,
                                 scfg, noise=torch.from_numpy(jitted)).numpy()
    d = np.abs(got.astype(np.float64) - ref)
    assert (d <= 1e-5).mean() >= 0.999 and d.max() <= PCF_TAP + 1e-6


def test_tool_run_calls_the_barrier_per_call(monkeypatch, capsys):
    """tm_pallas calls K9's wrapper through the module attribute once per
    call (1 + 3 steady), which kernels.capture_inputs sees; each call's
    PCSS evaluate calls the sincos wrapper once (its IGN disk rotation);
    no other kernel runs; on the CPU the plain versions run and nothing
    launches. main() takes the CPU under REPRO_CPU."""
    monkeypatch.setenv("REPRO_CPU", "1")
    before = kernels.launch_counts()
    with kernels.capture_inputs() as captured:
        res = tool.main(["tm_pallas"])
    calls = captured.pop("fusion_barrier")
    assert len(calls) == 4
    for args, _ in calls:
        assert args[0].shape == (tool.HP, tool.WP)
        assert args[0].dtype == torch.float32
    trig = captured.pop("sincos")
    assert len(trig) == 4
    for args, _ in trig:
        assert args[0].shape == (tool.HP, tool.WP)
    assert not any(captured.values())
    assert kernels.launch_counts() == before
    assert res["out"][0].shape == (tool.HE, tool.WE)
    out = capsys.readouterr().out
    assert "tm_pallas compile+run ok" in out and "tm_pallas steady ok" in out
