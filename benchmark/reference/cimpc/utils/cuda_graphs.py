"""No CUDA graph is captured in the reference."""

import contextlib


def capturable_linalg(like):
    return contextlib.nullcontext()
