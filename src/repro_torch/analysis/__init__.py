"""`repro_torch.analysis` — the port's trace hygiene as a tool.

Counterpart of `repro.analysis`, with its names, rule ids, CLI flags and
printed summary lines, so the two read side by side:

  lint       pure-stdlib AST linter over the port's tree: host syncs in
             the round / engine / client-step hot paths (``.item()``,
             ``.cpu()``, ``.tolist()``, ``.numpy()``, synchronize calls,
             ``float(tensor)``), retrace hazards (a CUDA graph, mesh,
             group, compile or kernel library made per call; fresh torch
             constants per round) and purity (module-global mutation, the
             global numpy or torch RNG, a ``torch.Generator`` made inside
             a hot scope). Findings carry file:line, rule id and a fix
             hint; ``src/repro_torch/analysis/baseline.json`` pins the
             accepted set. The comment syntax is the reference's, so one
             ``# analysis:`` mark serves both linters.

  contracts  every AGGREGATORS / SCHEME_WEIGHTS / CLIENT_UPDATES /
             TOPOLOGIES / CODECS entry, and the serving tier's snapshot
             framing, interpreted over fake CPU tensors
             (``FakeTensorMode``) against the reference's structural
             contracts, with the full-width ResNet-18-CIFAR tree and
             nothing allocated.

  guards     runtime rails shared by the engine, chip_smoke.py and the
             tests: ``no_implicit_transfers()`` (the CUDA sync debug mode
             as "error") around the replayed rounds, and
             ``track_compiles()`` / ``assert_compile_bounds()`` over graph
             captures and kernel builds, the campaign bound in one place
             (``ENGINE_COMPILE_BOUNDS``).

Run the static layers from the repo root:

    python -m repro_torch.analysis.lint src/repro_torch
    python -m repro_torch.analysis.contracts

Import-light on purpose: submodules are imported explicitly, never from
here.
"""
__all__ = ["contracts", "guards", "lint"]
