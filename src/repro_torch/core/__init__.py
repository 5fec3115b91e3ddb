"""Federated round: mobility, augmentations, DT loss, cohort, aggregation, client, topology, scenario."""
