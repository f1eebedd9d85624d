"""The structure mode's KKT solve: the plain version, always."""


def route(device, dtype, nq: int, nu: int, h: int) -> str:
    return "plain"


def structure_kkt(*args):
    raise RuntimeError("the reference takes the plain structured solve")
