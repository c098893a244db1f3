"""Tools of the port (port of ``minizero_tpu/tools``)."""
