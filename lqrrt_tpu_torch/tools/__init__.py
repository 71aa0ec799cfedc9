"""Experiment entry points of the port (counterparts of the JAX repo's
``tools/`` scripts); each runs with ``python -m lqrrt_tpu_torch.tools.<name>``."""
