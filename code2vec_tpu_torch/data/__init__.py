"""Host-side data helpers (own copies of the JAX package's)."""
