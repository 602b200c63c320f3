"""Debug-mode checks: NaN trapping and checkified SDF evaluation.

The reference's only sanitizer is a compile-time ``-Xptxas -warn-double-usage``
(build.rs:116,120) and it has no runtime asserts. This build leans on
JAX's functional purity plus the two opt-in mechanisms here (SURVEY §5):

* :func:`debug_mode` — context manager flipping ``jax_debug_nans`` (every op
  re-checked for NaN production; slow, debug only).
* :func:`checked_sdf` — wraps an SDF so each batched evaluation carries a
  ``checkify`` error that callers can raise on the host: catches NaN/Inf
  distances (e.g. un-normalized directions, bad params) inside jit.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import jax
import jax.numpy as jnp
from jax.experimental import checkify


@contextlib.contextmanager
def debug_mode(nan_checks: bool = True, x64: bool = False):
    """Enable heavyweight runtime checking within the context."""
    old_nan = jax.config.jax_debug_nans
    old_x64 = jax.config.jax_enable_x64
    try:
        jax.config.update("jax_debug_nans", nan_checks)
        jax.config.update("jax_enable_x64", x64)
        yield
    finally:
        jax.config.update("jax_debug_nans", old_nan)
        jax.config.update("jax_enable_x64", old_x64)


def checked_sdf(sdf: Callable, name: str = "sdf") -> Callable:
    """Return ``f(p) -> (err, d)`` asserting all distances are finite.

    Use with ``err.throw()`` on the host, or fold errors through jit with
    ``checkify.checkify``-composed callers.
    """

    def inner(p):
        d = sdf(p)
        checkify.check(
            jnp.all(jnp.isfinite(d)), f"{name}: non-finite distance detected"
        )
        return d

    return checkify.checkify(inner)


def assert_finite(x: jax.Array, name: str = "array") -> None:
    """Host-side finite check for eager/test code paths."""
    import numpy as np

    arr = np.asarray(x)
    if not np.all(np.isfinite(arr)):
        bad = int((~np.isfinite(arr)).sum())
        raise FloatingPointError(f"{name}: {bad} non-finite values")
