"""Models of the serving path (counterparts of the JAX ``models/``)."""
