"""Benchmark datasets for the port."""
