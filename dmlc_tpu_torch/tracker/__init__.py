"""Launch and rendezvous: the rabit tracker (``tracker.rendezvous``: fixed
worlds, recovery, heartbeats with the status plane's payloads, warm spares
and elastic generations), the PS scheduler bootstrap (``PSTracker``), the
worker-side ``send_heartbeat`` / ``request_join``, the launchers behind
``python -m dmlc_tpu_torch.tracker.submit`` (``tracker.opts``,
``tracker.launchers``: local, gpu, ssh, mpi, sge, slurm, yarn, mesos,
kubernetes) and the in-container shim (``tracker.shim``)."""

from dmlc_tpu_torch.tracker.rendezvous import (
    MAGIC,
    FramedSocket,
    PSTracker,
    RabitTracker,
    SpareUnused,
    build_link_maps,
    get_host_ip,
    request_join,
    send_heartbeat,
    submit_with_tracker,
)

__all__ = ["MAGIC", "FramedSocket", "PSTracker", "RabitTracker", "SpareUnused",
           "build_link_maps", "get_host_ip", "request_join",
           "send_heartbeat", "submit_with_tracker"]
