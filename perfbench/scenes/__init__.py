"""Frozen numpy builders of the configurations' scenes, one module per
builder name (a configuration's ``"builder"``): ``build(**args)``
returns the arrays of :mod:`.assemble`'s :class:`~.assemble.Arrays`."""
