"""Metric readers, one file a metric named as in `BENCHMARK.json`
(`<name>.py`, loaded by path): `read(run)` returns the metric's value, or
None where the run holds nothing for it to read."""
