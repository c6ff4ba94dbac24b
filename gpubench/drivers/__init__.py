"""Loops that run a traffic mix, one file per ``driver`` a mix names.

A driver module holds ``Driver(cell, seed, device, spans, fault=None)``
with ``setup()``, ``window(seconds) -> work``, ``end_to_end(work)`` and
``check(limits) -> {name: (value, limit)}``.
"""
