from . import distributed
from .mesh import make_mesh
from .rollouts import (MPCSweepStats, RolloutStats, monte_carlo_rollouts,
                       make_sharded_mpc_rollouts, sharded_mpc_rollouts,
                       sharded_rollouts,
                       sharded_rollout_stats)
