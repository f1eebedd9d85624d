"""contactimplicitmpc_tpu_torch — the PyTorch/CUDA port of
``contactimplicitmpc_tpu``.

Same module layout and public names as the JAX package; plain functions on
tensors with an explicit leading batch axis. The entry points that make
tensors take ``device`` and put them on the GPU when it is left out
(``default_device``; it raises where there is no GPU, and ``device="cpu"``
asks for the CPU); functions that receive tensors follow their inputs.
The JAX package's one TPU kernel, the batched knot interior-point solve, is
a hand-written CUDA kernel for Hopper (``csrc/knot_ip.cu``, wrapper
``ops/knot_ip.py``). ``parallel/`` splits a Monte-Carlo sweep's lanes over
the ranks of a ``torch.distributed`` process group (one process a GPU)
and reduces its statistics with one all-reduce; ``utils/`` holds the gait
loader, the spans, and the visuals (``visuals.py``, ``meshes.py``,
``live.py``: matplotlib figures and animations of port tensors).
"""

import torch as _torch

# The interior-point iterations stop converging with reduced-precision
# products (TF32 keeps ~10 mantissa bits), so pin full float32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from .device import default_device  # noqa: E402
from .dims import Dims  # noqa: E402
from .env import (ENVIRONMENTS, Environment,  # noqa: E402
                  circular_bowl_3d_nc, environment_2d, environment_2d_flat,
                  environment_3d, environment_3d_flat, flat_2d_lc,
                  flat_2d_nc, flat_3d_lc, flat_3d_nc, piecewise1_2d_lc,
                  piecewise2_2d_lc, quadratic_bowl_3d_lc,
                  quadratic_bowl_3d_nc, sine1_2d_lc, sine1_3d_lc,
                  sine2_2d_lc, sine2_3d_lc, sine3_2d_lc, sine3_3d_lc,
                  slope1_2d_lc, slope_smooth_2d_lc, smoothed_stairs_2d_lc,
                  stairs3_2d_lc)
from .models.base import Model, dims_of, dynamics  # noqa: E402
from .sim.interior_point import (IPOptions, IPResult, ip_solve,  # noqa: E402
                                 z_initialize, z_warmstart)
from .sim.residual import (pack_theta, pack_z,  # noqa: E402
                           pack_z_consistent, residual,
                           residual_theta_jacobian, residual_z_jacobian,
                           unpack_theta, unpack_z)
from .sim.simulator import (PolicyObs, SimTrajectory,  # noqa: E402
                            control_saturation, default_sim_options,
                            empty_disturbances, empty_policy,
                            impulse_disturbances, open_loop_disturbances,
                            open_loop_policy, random_disturbances,
                            saturated_policy, simulate, status)
from .control.policy import CIMPCOptions, ci_mpc_policy  # noqa: E402

__version__ = "0.1.0"
