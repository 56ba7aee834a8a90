"""Host data helpers of the port (its own copies of the JAX package's)."""
