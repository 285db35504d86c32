"""Command-line tools built on the repro_torch package (DESIGN.md §9.11)."""
