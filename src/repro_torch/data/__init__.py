"""Deterministic synthetic token pipeline (a copy of the reference's
`data/pipeline.py`: numpy only)."""
