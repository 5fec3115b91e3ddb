"""Launchers of the port (counterpart of `repro.launch`): `launch.serve`
(train and serve FL rounds), `launch.steps` and `launch.decode` (the
zoo's prefill and decode), `launch.dryrun` (the zoo's mesh steps traced
on a fake world)."""
