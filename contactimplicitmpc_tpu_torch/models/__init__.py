"""The port's robot models, by the JAX package's registry names
(``contactimplicitmpc_tpu/models/__init__.py``): every one of them."""

from .base import (Model, contact_forces, dims_of, dynamics, e_mapping,
                   lagrangian_derivatives, velocity_stack)
from .centroidal_quadruped import (CentroidalQuadruped,
                                   centroidal_quadruped,
                                   centroidal_quadruped_undamped,
                                   relative_state_cost)
from .centroidal_quadruped_variants import (CentroidalQuadrupedBox,
                                            CentroidalQuadrupedWall,
                                            centroidal_quadruped_box,
                                            centroidal_quadruped_wall,
                                            centroidal_quadruped_wall_slanted)
from .flamingo import Flamingo, flamingo
from .hopper_2d import Hopper2D, hopper_2d
from .hopper_3d import Hopper3D, hopper_3d
from .particle import Particle, particle
from .particle_2d import Particle2D, particle_2d
from .point_foot_quadruped import PointFootQuadruped, point_foot_quadruped
from .pushbot import PushBot, pushbot
from .quadruped import Quadruped, quadruped, quadruped_payload
from .walledcartpole import WalledCartpole, walledcartpole

MODELS = {
    "particle": particle,
    "particle_2D": particle_2d,
    "hopper_2D": hopper_2d,
    "hopper_3D": hopper_3d,
    "quadruped": quadruped,
    "quadruped_payload": quadruped_payload,
    "flamingo": flamingo,
    "pushbot": pushbot,
    "walledcartpole": walledcartpole,
    "centroidal_quadruped": centroidal_quadruped,
    "centroidal_quadruped_undamped": centroidal_quadruped_undamped,
    "centroidal_quadruped_box": centroidal_quadruped_box,
    "centroidal_quadruped_wall": centroidal_quadruped_wall,
    "centroidal_quadruped_wall_slanted": centroidal_quadruped_wall_slanted,
    "point_foot_quadruped": point_foot_quadruped,
}
