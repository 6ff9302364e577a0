"""Launch and rendezvous: the rabit tracker (``tracker.rendezvous``: fixed
worlds, recovery, heartbeats, warm spares and elastic generations), the
worker-side ``send_heartbeat`` / ``request_join``, and the local launcher
behind ``python -m dmlc_tpu_torch.tracker.submit`` (``tracker.opts``,
``tracker.launchers``)."""

from dmlc_tpu_torch.tracker.rendezvous import (
    MAGIC,
    FramedSocket,
    RabitTracker,
    SpareUnused,
    build_link_maps,
    get_host_ip,
    request_join,
    send_heartbeat,
    submit_with_tracker,
)

__all__ = ["MAGIC", "FramedSocket", "RabitTracker", "SpareUnused",
           "build_link_maps", "get_host_ip", "request_join",
           "send_heartbeat", "submit_with_tracker"]
