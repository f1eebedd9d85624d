"""A frozen copy of the plain (CPU) modules of ``contactimplicitmpc_tpu_torch``
that the benchmark's comparison runs as its reference: the models and
terrains, the sim step's interior point, the linearization about the gait
knots, the knot solve and both Newton modes.

The modules are copied as they stood when the benchmark was defined, so
that a later change to the program leaves the yardstick as it is. Only the
program's routes to its CUDA kernels are replaced, by the small modules
``device``, ``ops/knot_ip``, ``ops/structure_kkt``, ``ops/ldl`` and
``utils/*`` here: every solve takes its plain version. Nothing here
imports the program.
"""
