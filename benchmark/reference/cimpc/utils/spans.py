"""The reference records no spans."""

import contextlib


def span(name, like=None):
    return contextlib.nullcontext()
