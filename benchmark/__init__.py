"""The benchmark of ``contactimplicitmpc_tpu_torch`` on an NVIDIA GPU; see
``README.md``. ``run.py`` is its one command."""
