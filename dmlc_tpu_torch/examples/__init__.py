"""Examples built from the port's parallel layers (counterparts of the
repository's ``examples/*.py``), run as ``python -m
dmlc_tpu_torch.examples.<name>``."""
