"""Representation-quality probes (counterpart of `repro.eval`)."""
