"""The package's former import name, kept so that existing imports keep
working: this package and each module under it are the ``approximatenn``
modules of the same path."""

from approximatenn.utils.alias import alias_package

alias_package(__name__, "approximatenn")
