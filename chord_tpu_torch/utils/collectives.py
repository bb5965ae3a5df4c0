"""The reductions of the strip-parallel frame on torch.distributed (the
port of chord_tpu's `jax.lax.psum` over its mesh axis).

A process group takes the place of chord_tpu's named axis: each rank of
the group renders one strip of the image (parallel/sharded.py). The gloo
backend always reduces in host memory: the port copies a device tensor
to the host, reduces the copy and copies the sum back, every time and
whatever the tensor, so a gloo run takes one route on every build of
torch (gloo's support of CUDA tensors varies by build). NCCL reduces the
device tensor in place.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops._util import const


def reduces_on_host(group) -> bool:
    """True when `group` reduces in host memory (gloo)."""
    return dist.get_backend(group) == dist.Backend.GLOO


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of `t` over the ranks of `group`, a new tensor on t's
    device (every rank gets the same bits)."""
    if reduces_on_host(group):
        out = t.detach().to("cpu", copy=True)
        dist.all_reduce(out, group=group)
        return out.to(t.device)
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def all_reduce_mean(t: torch.Tensor, group) -> torch.Tensor:
    """The f32 mean of `t` over `group`: the sum divided by the group's
    size (chord_tpu's `psum(x) / psum(1.0)`; an IEEE divide by a device
    constant, not a multiply by its reciprocal)."""
    n = float(dist.get_world_size(group))
    return all_reduce_sum(t, group) / const(n, t.device)
