"""Checkpoints of the port (store.py), in the reference's npz format."""
