"""Command-line tools of the port: ``python -m dmlc_tpu_torch.tools.parity``
(a socket-engine world against one process, with the ulp report)."""
