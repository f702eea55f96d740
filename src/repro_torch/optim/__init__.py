"""AdamW and its schedules (port of the JAX package's `optim`)."""
