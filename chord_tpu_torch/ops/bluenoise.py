"""Per-pixel low-discrepancy noise (port of chord_tpu/ops/bluenoise.py).

Interleaved gradient noise (Jimenez) with a per-frame shift, computed in
place of a blue-noise texture fetch: its spectrum is blue-ish over 3x3
neighbourhoods, which is what the temporal accumulators need.
"""

from __future__ import annotations

import torch


def interleaved_gradient_noise(h: int, w: int, frame=0,
                               device=None) -> torch.Tensor:
    """-> (h, w) f32 in [0, 1). `frame` may be an int or an int tensor;
    the shift walks each pixel through 64 phases. `device` defaults to the
    frame tensor's device, else the card."""
    if isinstance(frame, torch.Tensor):
        device = device or frame.device
        fj = torch.remainder(frame.to(torch.int32), 64).float()
    else:
        fj = torch.tensor(float(int(frame) % 64))
    if device is None:
        device = torch.device("cuda")
    fj = fj.to(device)
    x = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    y = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xo = x + 5.588238 * fj
    v = 52.9829189 * torch.remainder(0.06711056 * xo + 0.00583715 * y, 1.0)
    return torch.remainder(v, 1.0)
