"""Weight bridges into the port (`jax_params`: JAX parameter trees -> state dicts)."""
