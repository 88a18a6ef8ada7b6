"""Lazy package exports (the port's copy of ``bpe_transformer_tpu/_lazy.py``).

Some packages export names whose modules import ``torch`` at load time,
while other modules of the same package (the router, the fleet aggregator,
the controller, the incident bundler, the KV wire codec) run on front-end
hosts that have no ``torch`` at all.  Each such ``__init__`` declares a
name -> submodule map and installs::

    __getattr__ = lazy_attrs(__name__, {"PagedEngine": "paged_engine", ...})

so importing one torch-free submodule never loads the others.
"""

from __future__ import annotations

import importlib
import sys


def lazy_attrs(package: str, mapping: dict[str, str]):
    """A module ``__getattr__`` resolving each name in ``mapping`` from
    ``package.<submodule>`` on first access and caching it on the package
    module."""

    def __getattr__(name: str):
        submodule = mapping.get(name)
        if submodule is None:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        value = getattr(importlib.import_module(f"{package}.{submodule}"), name)
        setattr(sys.modules[package], name, value)  # resolve once
        return value

    return __getattr__
