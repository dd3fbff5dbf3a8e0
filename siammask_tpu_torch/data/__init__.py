"""Training targets (host-side numpy)."""
