"""The benchmark's reference (see benchmark/run.py)."""
