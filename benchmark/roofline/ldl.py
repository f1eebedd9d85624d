"""The direct mode's KKT solve, the unpivoted LDLᵀ on a thread-block
cluster a matrix (``csrc/ldl.cu``), one call on ``batch`` matrices of
n × n; a copy of ``ops/ldl.py::work`` as it stood when the benchmark was
defined."""

KERNEL = r"ldl_kernel"


def work(n: int, batch: int, elem_bytes: int) -> tuple:
    """(floating-point operations, bytes): the factor's n³/3, the two unit
    triangular solves' 2 n² and the diagonal's n divisions; the lower
    triangle of the matrix, the right-hand side and the solution once."""
    factor = sum((n - k - 1) + (n - k - 1) * (n - k) for k in range(n))
    flops = batch * (factor + 2 * n * (n - 1) + n)
    nbytes = batch * elem_bytes * (n * (n + 1) // 2 + 2 * n)
    return flops, nbytes
