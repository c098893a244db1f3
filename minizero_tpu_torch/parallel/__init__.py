"""Multi-GPU plumbing of the port (port of ``minizero_tpu/parallel``)."""
