"""The port's examples, counterparts of the repository's
``examples/*.py``, run as ``python -m dmlc_tpu_torch.examples.<name>``:
``parameter`` (host), ``criteo_sparse``, ``boosted_trees``,
``distributed_sgd``, ``long_context`` and ``moe_transformer``."""
