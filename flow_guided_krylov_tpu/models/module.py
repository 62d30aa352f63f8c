"""A minimal functional module layer in plain JAX.

Models are frozen dataclasses whose methods read their parameters through
:meth:`Module.param` and :meth:`Module.dense`.  ``init(key, *args,
method=...)`` runs a method once to create the parameters and returns them
as ``{"params": {...}}``; ``apply(variables, *args, method=...)`` runs a
method against given parameters.  ``method`` is a bound method of the
model (``model.sample``) or None for ``__call__``.  Every parameter has an
explicit name; :meth:`Module.scope` nests names one level down.

Each parameter's initial value is drawn from the init key folded with a
hash of its path, so it does not depend on the order in which a method
creates its parameters.
"""

from __future__ import annotations

import contextlib
import copy
import zlib
from typing import Any, Callable, Dict, Optional, Sequence

import jax
import jax.numpy as jnp

__all__ = ["Module", "dense_kernel_init"]

# flax.linen.Dense defaults: LeCun-normal kernel, zero bias
dense_kernel_init = jax.nn.initializers.lecun_normal()


class _Frame:
    """Parameter tree of one ``init``/``apply`` call and the current path."""

    def __init__(self, params: Dict, key: Optional[jax.Array]):
        self.params = params
        self.key = key                 # None: apply (parameters must exist)
        self.path: list = []


class Module:
    """Base class of the models; subclasses are frozen dataclasses."""

    _frame = None       # set on the bound copy that init/apply runs

    # -- entry points --------------------------------------------------

    def init(self, key: jax.Array, *args, method: Optional[Callable] = None,
             **kwargs) -> Dict[str, Any]:
        frame = _Frame({}, key)
        self._run(frame, method, args, kwargs)
        return {"params": frame.params}

    def apply(self, variables: Dict[str, Any], *args,
              method: Optional[Callable] = None, **kwargs):
        return self._run(_Frame(variables["params"], None), method, args,
                         kwargs)

    def _run(self, frame: _Frame, method, args, kwargs):
        fn = type(self).__call__ if method is None else method
        fn = getattr(fn, "__func__", fn)
        bound = copy.copy(self)
        object.__setattr__(bound, "_frame", frame)
        return fn(bound, *args, **kwargs)

    # -- parameters ------------------------------------------------------

    def param(self, name: str, init: Callable, shape: Sequence[int],
              dtype=jnp.float32) -> jnp.ndarray:
        """The parameter ``name`` in the current scope; created with
        ``init(key, shape, dtype)`` during ``init``."""
        frame = self._frame
        if frame is None:
            raise RuntimeError("parameters exist only inside init/apply")
        node = frame.params
        for part in frame.path:
            node = node.setdefault(part, {}) if frame.key is not None \
                else node[part]
        if name not in node:
            if frame.key is None:
                raise KeyError("/".join(frame.path + [name]))
            tag = zlib.crc32("/".join(frame.path + [name]).encode())
            node[name] = init(jax.random.fold_in(frame.key, tag),
                              tuple(shape), dtype)
        return node[name]

    @contextlib.contextmanager
    def scope(self, name: str):
        """Nest the parameters created inside under ``name``."""
        self._frame.path.append(name)
        try:
            yield
        finally:
            self._frame.path.pop()

    def dense(self, x: jnp.ndarray, features: int, name: str,
              dtype=None) -> jnp.ndarray:
        """Affine layer ``x @ kernel + bias`` with flax's default
        initializers; ``dtype`` sets the compute type (parameters stay
        float32)."""
        with self.scope(name):
            kernel = self.param("kernel", dense_kernel_init,
                                (x.shape[-1], features))
            bias = self.param("bias", jax.nn.initializers.zeros,
                              (features,))
        if dtype is not None:
            x, kernel, bias = (x.astype(dtype), kernel.astype(dtype),
                               bias.astype(dtype))
        return x @ kernel + bias
