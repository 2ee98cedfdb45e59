"""Faults planted in a run's timed path, for the checks that `correct`
catches them: each driver module names its own in `FAULTS`, as
{name: (module, attribute, wrap)}, where `wrap(original)` returns the
broken stand-in. The attribute may be dotted (`Adam.step`)."""
from __future__ import annotations

import contextlib
import importlib


@contextlib.contextmanager
def planted(fault):
    module, attr, wrap = fault
    *parents, last = attr.split(".")
    owner = importlib.import_module(module)
    for p in parents:
        owner = getattr(owner, p)
    original = getattr(owner, last)
    setattr(owner, last, wrap(original))
    try:
        yield
    finally:
        setattr(owner, last, original)
