"""The knot solve (``csrc/knot_ip.cu``: a prologue that packs the knots and
the solve, in a warp or a block template), one call on ``n`` problems over
``k`` knots; a copy of ``ops/knot_ip.py::work`` as it stood when the
benchmark was defined. ``dims`` holds nx, ny, nz, ntheta, nq, nc."""

KERNEL = r"knot_(ip|pack)(_wide)?_kernel"


def work(dims: dict, n: int, k: int, iters: int, refine: int,
         max_ls: int) -> tuple:
    """(floating-point operations, bytes) of one call: the least the
    function needs, a multiply-add counted as two, the per-knot constants
    once a knot, an in-place Gauss-Jordan inverse (2 m³), a line search
    whose 2 (max_ls + 1) candidates share two Jacobian products; all
    ``iters`` iterations (a fixed-iteration solve computes them all); every
    input and output once."""
    nx, ny, nz, nt = dims["nx"], dims["ny"], dims["nz"], dims["ntheta"]
    ne = nx + ny
    gauss_jordan = lambda m: 2 * m * m * m
    schur = 2 * (ny * nx + ny * ny + nx * ny + nx * nx) + 6 * ny
    apply_jac = 2 * ne * nz + 3 * ny + nz
    solve = schur + refine * (apply_jac + schur + nz)
    residual = 2 * ne * nz + nz + ne + 2 * ny
    candidate = 4 * ne + 8 * ny
    search = 2 * (2 * ne * nz) + 2 * (max_ls + 1) * candidate + 2 * nz
    factor = gauss_jordan(ny) + 3 * ny + ny * ny
    steps = 3 * 4 * ny + 8 * ny + 3 * ny
    iteration = residual + factor + 3 * solve + search + steps
    final = residual + factor + nt * solve
    per_problem = 2 * ne * nt + nt + 2 * ne + iters * iteration + final
    per_knot = gauss_jordan(nx) + 2 * ny * nx * nx + 2 * ny * ny * nx
    flops = n * per_problem + k * per_knot
    bytes_in = 4 * n * (nt + dims["nq"] + dims["nc"]) \
        + 4 * k * (nz + nt + nz + nz * nz + nz * nt)
    bytes_out = n * (4 * (nz + nz * nt + 2) + 1)
    return flops, bytes_in + bytes_out
