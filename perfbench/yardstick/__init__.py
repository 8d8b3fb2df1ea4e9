"""The yardstick: what the benchmark measures with, kept apart from the
program under test (which it never imports)."""
