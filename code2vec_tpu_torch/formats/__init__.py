"""Artifact formats shared with the JAX package (own copies)."""
