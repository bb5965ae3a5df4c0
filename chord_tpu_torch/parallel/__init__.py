"""Multi-device rendering: strip-parallel frames on torch.distributed."""

from .sharded import (ShardedRenderer, dryrun, spawn_strips,  # noqa: F401
                      strip_device_views, strip_view)
