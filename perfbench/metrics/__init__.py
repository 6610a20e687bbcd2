"""Metric readers, one module per metric name in ``BENCHMARK.json``; each
exposes ``read(run)``, which returns the number or ``None`` when the run
holds nothing to read (the harness then leaves the metric out)."""
