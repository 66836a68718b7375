"""CPU tests of the benchmark (run: python -m pytest gpubench/tests -q)."""
