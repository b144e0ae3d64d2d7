"""Launchers of the port (``src/repro/launch``): ``train`` (the training
launcher, over a mesh), ``mesh`` (the production and debug meshes),
``specs`` (abstract inputs with their placements) and ``dryrun`` (every
configuration × shape × production mesh cell's layout and bytes)."""
