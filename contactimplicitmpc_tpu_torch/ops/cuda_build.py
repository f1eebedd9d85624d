"""Building the port's CUDA sources: ``nvcc`` into a shared library with a
plain C interface, loaded by the wrappers with ``ctypes``.

A library is compiled at first use from the repository's source into
``build/`` (listed in ``.gitignore``), named by the hash of the source, the
headers it includes and the flags, and reused while they stay the same.
Building needs the CUDA toolkit: ``nvcc`` on the path, or under
``$CUDA_HOME`` or ``/usr/local/cuda``. What ``-Xptxas -v`` says of each
kernel is kept beside the library (``<library>.ptxas``); ``resources``
reads it. ``bind_clocks`` and ``clocked`` read the phase clocks of the KKT
kernels' clocked builds (``csrc/kkt_clocks.cuh``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's kernels need the CUDA "
                           "toolkit to build")
    return path


def build(source: str, verbose: bool = False, deps=(), defines=()) -> str:
    """Compile ``source`` with the extra flags ``defines`` (``-D...``) into
    ``build/`` unless a library of the same hash of the source, its headers
    ``deps`` and the flags is there; returns the library's path.
    ``verbose`` prints what ``-Xptxas -v`` says of each kernel (registers,
    shared memory, spills)."""
    flags = [*NVCC_FLAGS, *defines]
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in (source, *deps):
        with open(path, "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(os.path.basename(source))[0]
    lib = os.path.join(BUILD_DIR, f"{stem}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *flags, "-Xptxas", "-v", "-o", tmp, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr, end="")
    with open(lib + ".ptxas", "w") as f:
        f.write(proc.stderr)
    os.replace(tmp, lib)
    return lib


def resources(lib: str) -> list:
    """Each kernel of the library at ``lib`` as ``-Xptxas -v`` reported it
    when it was built: ``{"kernel", "registers", "spill_stores",
    "spill_loads", "stack"}`` (bytes but the registers), in the report's
    order; empty where no report was kept."""
    try:
        with open(lib + ".ptxas") as f:
            text = f.read()
    except FileNotFoundError:
        return []
    out, name, props = [], None, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name and props == name:
            out.append({"kernel": name, "stack": int(m.group(1)),
                        "spill_stores": int(m.group(2)),
                        "spill_loads": int(m.group(3))})
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and out and out[-1]["kernel"] == name and "registers" not in out[-1]:
            out[-1]["registers"] = int(m.group(1))
    return out


def bind_clocks(lib) -> None:
    """Declare the clocked build's ``kkt_clocks_*`` functions
    (``csrc/kkt_clocks.cuh``) on the loaded library ``lib``."""
    import ctypes
    for name in ("kkt_clocks_slots", "kkt_clocks_reset", "kkt_clocks_read"):
        getattr(lib, name).restype = ctypes.c_int
    lib.kkt_clocks_read.argtypes = [ctypes.c_void_p]


def clocked(lib, phases, device, launch) -> dict:
    """One ``launch()`` of the clocked build ``lib`` on ``device``, its
    slots cleared before: {phase: SM clock cycles} over ``phases``, the
    source's phases in order."""
    slots = lib.kkt_clocks_slots()
    if slots < len(phases):
        raise RuntimeError(f"the clocked build has {slots} slots for "
                           f"{len(phases)} phases")
    torch.cuda.synchronize(device)
    if lib.kkt_clocks_reset() != 0:
        raise RuntimeError("clearing the phase clocks failed")
    launch()
    torch.cuda.synchronize(device)
    out = (ctypes.c_longlong * slots)()
    if lib.kkt_clocks_read(out) != 0:
        raise RuntimeError("reading the phase clocks failed")
    return dict(zip(phases, map(int, out)))
