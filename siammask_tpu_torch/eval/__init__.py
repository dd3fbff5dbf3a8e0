"""Benchmark datasets and the VOT region overlap for the port."""
