"""Jax-free host helpers of the serving path (copies of `cape_tpu.data`)."""
