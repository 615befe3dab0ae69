"""Tools of the benchmark that its runs do not use (see each file)."""
