"""Plain references of the benchmark. Nothing here imports the port,
``jax`` or the JAX package."""
