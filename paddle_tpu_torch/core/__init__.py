"""Runtime pieces of the port (counters, fault injection, the dtype policy):
the counterparts of parts of `paddle_tpu/core/`."""
