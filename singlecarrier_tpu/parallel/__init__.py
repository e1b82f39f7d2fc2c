from .mesh import make_mesh, device_count
from .sharded_rx import (make_channel_sharded_rx, make_grid_batch_rx,
                         make_sharded_batch_rx, metrics_summary,
                         shard_channel_state, shard_plane_state)
from .timeshard import (time_sharded_rx, make_time_sharded_rx,
                        grid_sharded_rx, make_grid_sharded_rx)

__all__ = [
    "make_mesh",
    "device_count",
    "make_channel_sharded_rx",
    "make_grid_batch_rx",
    "make_sharded_batch_rx",
    "metrics_summary",
    "shard_channel_state",
    "shard_plane_state",
    "time_sharded_rx",
    "make_time_sharded_rx",
    "grid_sharded_rx",
    "make_grid_sharded_rx",
]
