"""The benchmark's modes (see benchmark/run.py)."""
