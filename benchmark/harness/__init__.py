"""The benchmark's harness (see benchmark/run.py)."""
