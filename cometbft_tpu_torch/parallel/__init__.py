"""Multi-device sharding of signature batches (parallel/mesh.py)."""
