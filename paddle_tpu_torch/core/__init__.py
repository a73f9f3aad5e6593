"""Host-side runtime pieces of the port (counters, fault injection): the
counterparts of the jax-free parts of `paddle_tpu/core/`."""
