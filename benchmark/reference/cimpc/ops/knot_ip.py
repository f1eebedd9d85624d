"""The knot solve: the plain fixed-iteration version, always."""

from .fixed_ip import linearized_ip_fixed


def knot_ip(dims, z0_lin, theta0, r0, rz0, rtheta0, alt, theta, q2_init,
            opts, iters: int = 10):
    return linearized_ip_fixed(dims, z0_lin, theta0, r0, rz0, rtheta0, alt,
                               theta, q2_init, opts, iters)
