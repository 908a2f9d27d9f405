"""The run's guard against the JAX package: ``jax``, ``jaxlib``, ``flax``
or ``ecwam_tpu`` loaded in this process, compared by whole top-level
module names (``ecwam_tpu_torch`` begins with ``ecwam_tpu`` and is not
one of them)."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "ecwam_tpu"))


def forbidden_modules(modules=None) -> list[str]:
    """The names in ``modules`` (default ``sys.modules``) whose top-level
    name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
