"""Acceleration structures built on the host: the KD tree of
:mod:`.kdtree`."""
