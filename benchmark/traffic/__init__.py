"""The benchmark's traffic (see benchmark/run.py)."""
