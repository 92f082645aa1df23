"""The benchmark harness: lookup by name, the window of passes, the
profile, the arithmetic and the check (see benchmarks/README.md)."""
