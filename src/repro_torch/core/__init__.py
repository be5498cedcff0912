"""QAP primitives, the jax.random replica, PSA and the mapping API."""
