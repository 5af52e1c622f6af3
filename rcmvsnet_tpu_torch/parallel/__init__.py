"""Data parallelism of the port: one process per device (`mesh.py`), the
cross-rank BatchNorm (`sync_bn.py`)."""
