"""Arithmetic below float32 for the comparison's control.

PyTorch has no factorisation in bfloat16, so while ``factorisations_in_low_precision``
is active the few ``torch.linalg`` calls the reference makes take a
bfloat16 or float16 argument to float32, factor or solve there, and round
the result back to the argument's type; every other operation runs in the
low type itself. Nothing in a benchmark run enters it.
"""

from __future__ import annotations

import contextlib

import torch

_NAMES = ("inv", "cholesky_ex", "solve_triangular", "solve_ex",
          "lu_factor_ex", "lu_solve")
_LOW = (torch.bfloat16, torch.float16)


def _wrap(fn):
    def call(*args, **kwargs):
        low = next((a.dtype for a in args if isinstance(a, torch.Tensor)
                    and a.dtype in _LOW), None)
        if low is None:
            return fn(*args, **kwargs)
        up = [a.float() if isinstance(a, torch.Tensor) and a.is_floating_point()
              else a for a in args]
        out = fn(*up, **kwargs)
        down = lambda t: (t.to(low) if isinstance(t, torch.Tensor)
                          and t.dtype == torch.float32 else t)
        if isinstance(out, tuple):
            return type(out)(*(down(t) for t in out)) if hasattr(out, "_fields") \
                else tuple(down(t) for t in out)
        return down(out)
    return call


@contextlib.contextmanager
def factorisations_in_low_precision():
    saved = {name: getattr(torch.linalg, name) for name in _NAMES}
    try:
        for name, fn in saved.items():
            setattr(torch.linalg, name, _wrap(fn))
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.linalg, name, fn)
