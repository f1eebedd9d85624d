"""Nothing the benchmark runs may load JAX or the JAX package.

Modules are compared by their top-level name, the part before the first
dot, as a whole: ``contactimplicitmpc_tpu_torch`` is the program and is
allowed, ``contactimplicitmpc_tpu`` is the JAX package and is not."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "contactimplicitmpc_tpu"))


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (by default
    ``sys.modules``), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in names}
                  & FORBIDDEN)


def require_clean(when: str) -> None:
    """Exit with code 4, naming what was found on standard error, if a
    forbidden module is loaded."""
    found = forbidden_loaded()
    if found:
        print(f"benchmark: {', '.join(found)} loaded ({when}); the benchmark "
              "measures the PyTorch port alone", file=sys.stderr)
        sys.exit(4)
