"""The import guard: no JAX in the benchmark's process.

The port's package name begins with the JAX package's, so modules are
compared by their whole top-level name (the part before the first dot).
"""

from __future__ import annotations

import sys

BANNED = ("jax", "jaxlib", "flax", "cst_captioning_tpu")


def banned_modules(modules=None) -> list[str]:
    """The banned top-level names among ``modules`` (default
    ``sys.modules``), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(BANNED))


def check(where: str) -> None:
    """Exit with code 3, naming what was found on stderr, if a banned
    module is loaded."""
    found = banned_modules()
    if found:
        print(f"benchmark: {where}: banned modules loaded: "
              f"{', '.join(found)}", file=sys.stderr)
        sys.exit(3)
