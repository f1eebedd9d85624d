"""The direct mode's KKT solve: the plain unpivoted LDLᵀ, always."""

from .linsolve import ldl_solve


def ldl(a, b, boost: float = 0.0):
    return ldl_solve(a, b, boost)
