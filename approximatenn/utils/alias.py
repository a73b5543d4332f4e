"""Import a package under a second name.

``alias_package(old, new)`` makes ``import old`` and ``import old.x.y``
return the very module objects of ``new`` and ``new.x.y`` (no second
copy: classes, caches and jitted functions stay shared), so code written
against a former package name keeps working.
"""

from __future__ import annotations

import importlib
import importlib.abc
import importlib.util
import sys


class _AliasFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def __init__(self, old: str, new: str):
        self.old, self.new = old, new

    def find_spec(self, fullname, path=None, target=None):
        if fullname.startswith(self.old + "."):
            return importlib.util.spec_from_loader(fullname, self)
        return None

    def create_module(self, spec):
        module = importlib.import_module(self.new + spec.name[len(self.old):])
        # the import system overwrites __spec__ with the alias's; keep the
        # original here and put it back in exec_module
        spec.loader_state = module.__spec__
        return module

    def exec_module(self, module):
        module.__spec__ = module.__spec__.loader_state


def alias_package(old: str, new: str) -> importlib.abc.MetaPathFinder:
    """Make ``old`` and its submodules names of ``new``'s modules; returns
    the finder installed on ``sys.meta_path``."""
    sys.modules[old] = importlib.import_module(new)
    finder = _AliasFinder(old, new)
    sys.meta_path.insert(0, finder)
    return finder
