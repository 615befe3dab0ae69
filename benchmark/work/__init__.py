"""The benchmark's work (see benchmark/run.py)."""
