"""One module a traffic ``kind``: ``kinds/<kind>.py``, found by the
``kind`` that a cell's traffic file names, so a later kind is a new file
and edits none. Each module gives

- ``drive(cell, run) -> drivers.Session``: builds the program's object
  from the seed, drives it through its first steps (set-up; the capture
  for the reference), then counts whole steps for ``run.seconds``;
- ``judge(cell, capture, device) -> {number: reading}``: the plain
  reference's verdict on a capture, each number compared in ``checks``;
- ``control(cell, seed, device) -> capture``: the reference itself, one
  precision below the configuration's, in the program's place;
- ``FAULTS``: ``{name: context manager}``, each planting one fault
  under the timed path.
"""

from __future__ import annotations

import importlib


def load(kind: str):
    """The module of traffic kind ``kind``."""
    return importlib.import_module(f"benchmark.kinds.{kind}")
