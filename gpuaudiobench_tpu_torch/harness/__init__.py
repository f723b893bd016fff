"""Benchmark plugin API, runner and saturated streaming tier."""
