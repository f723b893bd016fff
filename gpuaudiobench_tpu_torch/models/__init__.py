"""Benchmark workload definitions ported so far."""
