"""Problem dimensions and index layouts for the contact NCP.

A copy of ``contactimplicitmpc_tpu/dims.py`` (pure Python): every layout is
a static Python slice derived from a frozen ``Dims`` dataclass.

Variable layout::

    z = [q2 (nq); gamma1 (nc); b1 (nb); psi1 (nc); s1 (nc); eta1 (nb); s2 (nc)]

Data layout::

    theta = [q0 (nq); q1 (nq); u1 (nu); w1 (nw); mu (1); h (1)]

Residual row layout::

    r = [dyn (nq); imp (nc); mdp (nb); fri (nc); bimp (nc); bmdp (nb); bfri (nc)]

Variables group into ``x = q2`` (nx = nq), ``y1 = [gamma1; b1; psi1]`` (ny)
and ``y2 = [s1; eta1; s2]`` (ny); residual rows into ``dyn`` (nx),
``rst = [imp; mdp; fri]`` (ny) and ``bil`` (ny). All three are contiguous.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Dims:
    """Static dimensions of one contact-dynamics NCP.

    Mirrors the information carried by ``(model, env)`` pairs in the
    reference (``num_var`` / ``num_data`` at index.jl:371-384).
    """

    nq: int  # configuration
    nu: int  # control
    nw: int  # disturbance
    nc: int  # contact points
    nf: int  # friction dim per contact (2 = 2D LC, 4 = 3D LC; index.jl via environment.jl:126-130)
    ne: int  # world dim (2 or 3)

    # ---- derived sizes -------------------------------------------------
    @property
    def nb(self) -> int:
        """Total linear-friction variables, nc * friction_dim."""
        return self.nc * self.nf

    @property
    def nz(self) -> int:
        """num_var (index.jl:371-377)."""
        return self.nq + 4 * self.nc + 2 * self.nb

    @property
    def ntheta(self) -> int:
        """num_data (index.jl:379-384)."""
        return 2 * self.nq + self.nu + self.nw + 2

    @property
    def ny(self) -> int:
        """num_bilinear (index.jl:386-390): nc + nb + nc."""
        return 2 * self.nc + self.nb

    @property
    def nx(self) -> int:
        return self.nq

    # ---- z slices (index.jl:13-107) -----------------------------------
    @property
    def iq2(self) -> slice:
        return slice(0, self.nq)

    @property
    def igamma1(self) -> slice:
        o = self.nq
        return slice(o, o + self.nc)

    @property
    def ib1(self) -> slice:
        o = self.nq + self.nc
        return slice(o, o + self.nb)

    @property
    def ipsi1(self) -> slice:
        o = self.nq + self.nc + self.nb
        return slice(o, o + self.nc)

    @property
    def is1(self) -> slice:
        o = self.nq + 2 * self.nc + self.nb
        return slice(o, o + self.nc)

    @property
    def ieta1(self) -> slice:
        o = self.nq + 3 * self.nc + self.nb
        return slice(o, o + self.nb)

    @property
    def is2(self) -> slice:
        o = self.nq + 3 * self.nc + 2 * self.nb
        return slice(o, o + self.nc)

    # ---- grouped variable slices (index.jl:289-301) --------------------
    @property
    def ix(self) -> slice:
        return slice(0, self.nx)

    @property
    def iy1(self) -> slice:
        return slice(self.nq, self.nq + self.ny)

    @property
    def iy2(self) -> slice:
        return slice(self.nq + self.ny, self.nq + 2 * self.ny)

    # ---- theta slices (index.jl:117-178) -------------------------------
    @property
    def iq0(self) -> slice:
        return slice(0, self.nq)

    @property
    def iq1(self) -> slice:
        return slice(self.nq, 2 * self.nq)

    @property
    def iu1(self) -> slice:
        o = 2 * self.nq
        return slice(o, o + self.nu)

    @property
    def iw1(self) -> slice:
        o = 2 * self.nq + self.nu
        return slice(o, o + self.nw)

    @property
    def imu(self) -> int:
        return 2 * self.nq + self.nu + self.nw

    @property
    def ih(self) -> int:
        return 2 * self.nq + self.nu + self.nw + 1

    # ---- residual row slices (index.jl:187-269) ------------------------
    @property
    def idyn(self) -> slice:
        return slice(0, self.nq)

    @property
    def iimp(self) -> slice:
        o = self.nq
        return slice(o, o + self.nc)

    @property
    def imdp(self) -> slice:
        o = self.nq + self.nc
        return slice(o, o + self.nb)

    @property
    def ifri(self) -> slice:
        o = self.nq + self.nc + self.nb
        return slice(o, o + self.nc)

    @property
    def irst(self) -> slice:
        """[imp; mdp; fri] — contiguous (index.jl:303-327)."""
        return slice(self.nq, self.nq + self.ny)

    @property
    def ibil(self) -> slice:
        """[bimp; bmdp; bfri] — contiguous (index.jl:303-327)."""
        return slice(self.nq + self.ny, self.nq + 2 * self.ny)
