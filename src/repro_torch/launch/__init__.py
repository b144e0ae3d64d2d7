"""Launchers of the port (``src/repro/launch``): ``train``, on one card."""
