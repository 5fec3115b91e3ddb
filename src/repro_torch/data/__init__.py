"""Synthetic dataset + partitioners (own copy of `repro.data`)."""
