"""Data-parallel training and sharded serving over several devices."""
