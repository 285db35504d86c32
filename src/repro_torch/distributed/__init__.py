"""Distributed-run support of the port (the reference's `distributed/`).

- `checkpoint` — atomic, integrity-checked checkpoints of flat array
                 dicts, in the reference's on-disk format
"""
