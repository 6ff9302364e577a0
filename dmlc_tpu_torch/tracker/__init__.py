"""The rabit rendezvous tracker of a fixed world (``tracker.rendezvous``)."""

from dmlc_tpu_torch.tracker.rendezvous import (
    MAGIC,
    FramedSocket,
    RabitTracker,
    build_link_maps,
    get_host_ip,
)

__all__ = ["MAGIC", "FramedSocket", "RabitTracker", "build_link_maps",
           "get_host_ip"]
