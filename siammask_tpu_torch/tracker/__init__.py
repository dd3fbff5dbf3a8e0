"""Single-object tracker and its host runtime."""
