"""The port's robot models, by the JAX package's registry names
(``contactimplicitmpc_tpu/models/__init__.py``) for the models ported so
far."""

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
from .hopper_2d import Hopper2D, hopper_2d
from .particle_2d import Particle2D, particle_2d
from .point_foot_quadruped import PointFootQuadruped, point_foot_quadruped
from .quadruped import Quadruped, quadruped

MODELS = {
    "particle_2D": particle_2d,
    "hopper_2D": hopper_2d,
    "quadruped": quadruped,
    "centroidal_quadruped": centroidal_quadruped,
    "centroidal_quadruped_undamped": centroidal_quadruped_undamped,
    "centroidal_quadruped_box": centroidal_quadruped_box,
    "centroidal_quadruped_wall": centroidal_quadruped_wall,
    "centroidal_quadruped_wall_slanted": centroidal_quadruped_wall_slanted,
    "point_foot_quadruped": point_foot_quadruped,
}
