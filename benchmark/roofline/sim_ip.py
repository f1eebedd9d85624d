"""The quadruped's sim step (``csrc/sim_ip.cu``, a block a problem), one
call on ``n`` problems that took ``trips`` iterations in all; a copy of
``ops/sim_ip.py::work`` (closed-form Jacobian) as it stood when the
benchmark was defined."""

KERNEL = r"sim_ip_kernel"

NZ, NT = 43, 34                 # the quadruped's z and θ on flat_2d_lc
CONSTANTS_SIZE = 257            # the model's packed constants, float64
RESIDUAL = 630                  # a residual's equality rows
JACOBIAN = ((17 * 30 + 2 * 9) + 2 * (9 + 17) + 71 * 4
            + (11 + 17 * 4 + 9 * 3 + 10 * 6) + 10 * 5 + 10
            + (8 + 2 * 10 * 6) + 4)


def work(n: int, trips: int, max_ls: int, refine: int,
         elem_bytes: int) -> tuple:
    """(floating-point operations, bytes): a multiply-add counted as two
    and a sine or cosine as one; a trip's closed-form Jacobian, Schur
    factors (two in-place Gauss-Jordans), three refined structured solves
    and 2 (max_ls + 1) candidates; every input and output once, the
    model's constants in float64."""
    nx, ny, ne, nz = 11, 16, 27, NZ
    gauss_jordan = lambda m: 2 * m * m * m
    factor = (JACOBIAN + gauss_jordan(nx) + 2 * ny * nx * nx
              + 2 * ny * ny * nx + ny * ny + 2 * ny)
    solve = 2 * (ny * nx + ny * ny + nx * ny + nx * nx) + 6 * ny
    apply_reg = 2 * ne * ne + ny + 3 * ny
    refined = solve + refine * (apply_reg + solve + 2 * nz)
    steps = 3 * 3 * 2 * ny + 2 * 4 * ny + 4 * nz
    candidate = RESIDUAL + 2 * nz + 3 * ny + 2 * nz + 4
    trip = (factor + 3 * refined + steps
            + 2 * (max_ls + 1) * candidate + 2 * nz + 3 * ny)
    per_problem = 400 + RESIDUAL + 3 * ny
    flops = n * per_problem + trips * trip
    nbytes = (8 * CONSTANTS_SIZE
              + elem_bytes * (n * (nz + NT) + n * (nz + 2))
              + n * (4 + 1))
    return flops, nbytes
