"""Shared machinery of the benchmark: cell lookup, the measured window and
its trace, seeded weights, the comparison limits and the result line."""
