"""contactimplicitmpc_tpu_torch — the PyTorch/CUDA port of
``contactimplicitmpc_tpu``.

Same module layout and public names as the JAX package; plain functions on
tensors with an explicit leading batch axis. The entry points that make
tensors take ``device`` and put them on the GPU when it is left out
(``default_device``; it raises where there is no GPU, and ``device="cpu"``
asks for the CPU); functions that receive tensors follow their inputs. The one TPU kernel of the main path, the batched knot
interior-point solve, is a hand-written CUDA kernel for Hopper
(``csrc/knot_ip.cu``, wrapper ``ops/knot_ip.py``).
"""

import torch as _torch

# The interior-point iterations stop converging with reduced-precision
# products (TF32 keeps ~10 mantissa bits), so pin full float32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from .device import default_device  # noqa: E402
from .dims import Dims  # noqa: E402
from .env import Environment, environment_2d_flat, flat_2d_lc  # noqa: E402

__version__ = "0.1.0"
