"""The structure mode's KKT solve (``csrc/structure_kkt.cu``), one call on
``batch`` problems of horizon ``h``; a copy of
``ops/structure_kkt.py::work`` as it stood when the benchmark was
defined."""

KERNEL = r"structure_kkt_kernel"


def work(nq: int, nu: int, h: int, batch: int, elem_bytes: int) -> tuple:
    """(floating-point operations, bytes): every stage's V, the lower
    triangle of its Yii block, its Cholesky, β's and the substitutions'
    terms and the step's recovery; the linked stages' W, off-diagonal
    block, M, Lⱼᵢ and their terms; every input and output once."""
    n, ns = 2 * nq, h - 1
    tri = lambda m: m * (m + 1) // 2
    cholesky = sum((n - k - 1) + (n - k - 1) * (n - k) for k in range(n))
    every = (2 * nq * nu * nu + tri(nq) * 2 * nu + cholesky
             + 2 * nu * nu + 2 * nq * nu + 8 * nq * nq
             + 2 * n * n + 2 * nq * nu + 2 * nu * nu + 8 * nq * nq)
    linked = (8 * nq ** 3 + tri(nq) * 4 * nq + 8 * nq ** 3 + tri(n) * 2 * n
              + n ** 3 + 16 * nq * nq + 4 * n * n + 4 * nq * nq)
    flops = batch * (ns * every + (ns - 1) * linked)
    objective = (h + 1) * (3 * nq * nq + nu * nu)
    inputs = batch * h * (2 * nq * nq + nq * nu + nu + 4 * nq)
    outputs = batch * h * (nu + 4 * nq)
    return flops, elem_bytes * (objective + inputs + outputs)
