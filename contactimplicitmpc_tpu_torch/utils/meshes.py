"""Mesh-class robot rendering from geometric primitives.

A copy of ``contactimplicitmpc_tpu/utils/meshes.py`` for the port; the
port's models place the geometry, and a configuration may be numpy or a
CPU or CUDA tensor (``visuals.host``). The equivalent of the reference's
MeshCat mesh stack (``visualize_meshrobot!``, ``src/visuals.jl:55-96`` and
the per-robot ``build_meshrobot!``/``set_mesh_robot!`` methods in
``src/dynamics/<robot>/visuals.jl``): instead of loading URDF mesh
assets into a browser scene, each robot's body geometry is built from
capsules / boxes / spheres positioned by the SAME kinematics the solver
uses, and rasterized head-lessly with matplotlib. This keeps full parity
on what the figures *communicate* (link volumes, body pose, feet,
payload, forces) without shipping third-party mesh files.

2D robots (hopper_2d, quadruped, flamingo, pushbot, walledcartpole)
render as filled capsule chains; 3D robots (centroidal quadruped +
variants, point-foot quadruped, hopper_3d) as boxes/capsules/spheres in
a 3D axes. The geometry is plain numpy.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# primitives


def capsule_2d(p0, p1, r: float, n: int = 9) -> np.ndarray:
    """Filled capsule (stadium) polygon around segment p0→p1."""
    p0 = np.asarray(p0, float)
    p1 = np.asarray(p1, float)
    d = p1 - p0
    L = float(np.hypot(*d))
    ang = np.arctan2(d[1], d[0]) if L > 1e-12 else 0.0
    # forward cap sweeps the half-disc facing +axis at p1
    # (ang−π/2 … ang+π/2), back cap the opposite half-disc at p0 — the
    # boundary then traces p1's cap, crosses to p0, traces its cap, and
    # closes: a proper stadium with the shaft interior inside
    ts = np.linspace(-np.pi / 2, np.pi / 2, n)
    cap1 = np.stack([np.cos(ts + ang), np.sin(ts + ang)], axis=1)
    cap0 = np.stack([np.cos(ts + ang + np.pi),
                     np.sin(ts + ang + np.pi)], axis=1)
    return np.concatenate([p1 + r * cap1, p0 + r * cap0], axis=0)


def circle_2d(c, r: float, n: int = 20) -> np.ndarray:
    ts = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    return np.asarray(c, float) + r * np.stack([np.cos(ts), np.sin(ts)],
                                               axis=1)


def box_3d(center, size, rot=None) -> List[np.ndarray]:
    """6 quad faces of a rotated box; ``size`` = full extents (3,)."""
    c = np.asarray(center, float)
    s = 0.5 * np.asarray(size, float)
    rot = np.eye(3) if rot is None else np.asarray(rot, float)
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)]) * s
    corners = corners @ rot.T + c
    idx = [(0, 1, 3, 2), (4, 5, 7, 6), (0, 1, 5, 4),
           (2, 3, 7, 6), (0, 2, 6, 4), (1, 3, 7, 5)]
    return [corners[list(f)] for f in idx]


def capsule_3d(p0, p1, r: float, n: int = 8) -> List[np.ndarray]:
    """Open cylinder faces around segment p0→p1 (ends closed by fans)."""
    p0 = np.asarray(p0, float)
    p1 = np.asarray(p1, float)
    d = p1 - p0
    L = float(np.linalg.norm(d))
    if L < 1e-9:
        return sphere_3d(p0, r, n)
    d = d / L
    # orthonormal frame around d
    a = np.array([1.0, 0.0, 0.0]) if abs(d[0]) < 0.9 else \
        np.array([0.0, 1.0, 0.0])
    e1 = np.cross(d, a)
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(d, e1)
    ts = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    ring = r * (np.outer(np.cos(ts), e1) + np.outer(np.sin(ts), e2))
    r0, r1 = p0 + ring, p1 + ring
    faces = []
    for i in range(n):
        j = (i + 1) % n
        faces.append(np.stack([r0[i], r0[j], r1[j], r1[i]]))
    faces.append(r0)  # end caps
    faces.append(r1)
    return faces


def sphere_3d(c, r: float, n: int = 8) -> List[np.ndarray]:
    c = np.asarray(c, float)
    us = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    vs = np.linspace(0.0, np.pi, max(n // 2, 3) + 1)
    faces = []
    for i in range(len(us)):
        for j in range(len(vs) - 1):
            u0, u1 = us[i], us[(i + 1) % len(us)]
            v0, v1 = vs[j], vs[j + 1]
            quad = []
            for (u, v) in ((u0, v0), (u1, v0), (u1, v1), (u0, v1)):
                quad.append(c + r * np.array([np.sin(v) * np.cos(u),
                                              np.sin(v) * np.sin(u),
                                              np.cos(v)]))
            faces.append(np.stack(quad))
    return faces


def mrp_rotation(p) -> np.ndarray:
    """MRP → rotation matrix (models/rotations.py convention)."""
    from .visuals import host

    p = np.asarray(host(p), float)
    n2 = float(p @ p)
    sk = np.array([[0, -p[2], p[1]], [p[2], 0, -p[0]],
                   [-p[1], p[0], 0.0]])
    return np.eye(3) + (8.0 * sk @ sk + 4.0 * (1.0 - n2) * sk) \
        / (1.0 + n2) ** 2


# ---------------------------------------------------------------------------
# per-robot geometry (body volumes, colors)

BODY = "#3b6fb5"
LIMB = "#7aa3d4"
FOOT = "#c44e52"


def body_polygons_2d(model, q) -> List[Tuple[np.ndarray, str]]:
    """Filled-primitive body geometry for the planar robots — capsule
    equivalents of the reference's per-robot meshes
    (src/dynamics/{quadruped,flamingo,hopper_2D,pushbot}/visuals.jl)."""
    from .visuals import host, kinematics, skeleton_2d

    q = np.asarray(host(q), float)
    name = type(model).__name__
    polys: List[Tuple[np.ndarray, str]] = []
    if name == "Hopper2D":
        body = q[:2]
        foot = kinematics(model, q)[0]
        polys.append((capsule_2d(body, foot, 0.02), LIMB))
        polys.append((circle_2d(body, 0.1), BODY))       # hopper body disc
        polys.append((circle_2d(foot, 0.03), FOOT))
        return polys
    if name in ("Quadruped", "Flamingo"):
        lines = skeleton_2d(model, q)
        # torso capsule is the first polyline; limbs follow
        torso = lines[0]
        polys.append((capsule_2d(torso[0], torso[-1], 0.05), BODY))
        for seg in lines[1:]:
            for k in range(len(seg) - 1):
                polys.append((capsule_2d(seg[k], seg[k + 1], 0.02), LIMB))
            polys.append((circle_2d(seg[-1], 0.025), FOOT))
        return polys
    if name == "PushBot":
        th = q[0]
        tip = model.l * np.array([-np.sin(th), np.cos(th)])
        polys.append((capsule_2d(np.zeros(2), tip, 0.04), BODY))
        polys.append((circle_2d(tip, 0.06), LIMB))
        return polys
    if name == "WalledCartpole":
        th, x = q[0], q[1]
        cart = np.array([x, 0.0])
        tip = cart + model.l * np.array([-np.sin(th), np.cos(th)])
        polys.append((cart + np.array([[-0.12, -0.04], [0.12, -0.04],
                                       [0.12, 0.04], [-0.12, 0.04]]), BODY))
        polys.append((capsule_2d(cart, tip, 0.02), LIMB))
        polys.append((circle_2d(tip, 0.05), FOOT))
        return polys
    # fallback: contact points as discs
    k = kinematics(model, q).reshape(-1, 2)
    return [(circle_2d(p, 0.03), FOOT) for p in k]


def body_faces_3d(model, q) -> List[Tuple[List[np.ndarray], str]]:
    """3D body geometry for the floating-base robots — primitive
    equivalents of build_meshrobot! for centroidal_quadruped /
    point-foot quadruped / hopper_3D
    (src/dynamics/centroidal_quadruped/visuals.jl etc.)."""
    from .visuals import feet_3d, host

    q = np.asarray(host(q), float)
    name = type(model).__name__
    body = q[:3]
    groups: List[Tuple[List[np.ndarray], str]] = []
    if name == "Hopper3D":
        foot = feet_3d(model, q)[0]
        groups.append((capsule_3d(body, foot, 0.02), LIMB))
        groups.append((sphere_3d(body, 0.1), BODY))
        groups.append((sphere_3d(foot, 0.03), FOOT))
        return groups
    # quadruped family: box torso oriented by the MRP + leg capsules
    rot = mrp_rotation(q[3:6])
    feet = feet_3d(model, q)
    # torso extents sized to the foot support rectangle
    span = np.abs(feet[:, :2] - body[:2]).max(axis=0)
    size = np.array([max(2 * span[0] * 0.8, 0.3),
                     max(2 * span[1] * 0.6, 0.15), 0.08])
    groups.append((box_3d(body, size, rot), BODY))
    for f in feet:
        # hip anchor: torso corner nearest the foot, in world frame
        local = rot.T @ (f - body)
        corner = np.sign(local) * 0.5 * size * np.array([1.0, 1.0, 0.0])
        hip = body + rot @ (corner * np.array([1, 1, 0]) -
                            np.array([0.0, 0.0, 0.5 * size[2]]))
        groups.append((capsule_3d(hip, f, 0.015), LIMB))
        groups.append((sphere_3d(f, 0.02), FOOT))
    return groups


# ---------------------------------------------------------------------------
# rendering


def render_robot_2d(model, q, env=None, ax=None, alpha: float = 1.0):
    """Draw one mesh-style robot pose into a matplotlib axes."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Polygon

    created = ax is None
    if created:
        _, ax = plt.subplots(figsize=(6, 4))
        ax.set_aspect("equal")
    arts = []
    for poly, color in body_polygons_2d(model, q):
        pa = Polygon(poly, closed=True, facecolor=color,
                     edgecolor="none", alpha=alpha, zorder=3)
        ax.add_patch(pa)
        arts.append(pa)
    return ax, arts


def render_robot_3d(model, q, ax, alpha: float = 1.0):
    """Draw one 3D mesh-style robot pose into a 3D axes."""
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    arts = []
    for faces, color in body_faces_3d(model, q):
        coll = Poly3DCollection(faces, facecolor=color,
                                edgecolor="none", alpha=alpha)
        ax.add_collection3d(coll)
        arts.append(coll)
    return arts


def animate_mesh_2d(model, qs, env=None, path: str = "mesh2d.gif",
                    every: int = 5, fps: int = 20, gamma=None, b=None,
                    force_scale: float = 3.0):
    """Mesh-style (filled-geometry) animation of a planar rollout → GIF —
    visualize_meshrobot! parity (src/visuals.jl:55-96) with the same
    overlay options as utils.visuals.animate_2d."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    from .visuals import contact_force_vectors, host, surface

    qs = host(qs)[::every]
    gamma = None if gamma is None else host(gamma)[::every]
    b = None if b is None else host(b)[::every]
    fig, ax = plt.subplots(figsize=(6, 4))
    xmin, xmax = qs[:, 0].min() - 1.0, qs[:, 0].max() + 1.0
    ax.set_xlim(xmin, xmax)
    ax.set_ylim(-0.2, 1.5)
    ax.set_aspect("equal")
    if env is not None:
        xs = np.linspace(xmin, xmax, 200)
        ax.plot(xs, surface(env, xs[:, None]), "k-", lw=1.0)
    else:
        ax.axhline(0.0, color="k", lw=1.0)

    artists: list = []

    def draw(i):
        for a in artists:
            a.remove()
        artists.clear()
        _, arts = render_robot_2d(model, qs[i], env, ax)
        artists.extend(arts)
        if gamma is not None and i < len(gamma):
            pts, vecs = contact_force_vectors(
                model, qs[i], gamma[i], None if b is None else b[i])
            art = ax.quiver(pts[:, 0], pts[:, 1], vecs[:, 0], vecs[:, 1],
                            angles="xy", scale_units="xy",
                            scale=1.0 / force_scale, color="C3",
                            width=4e-3, zorder=4)
            artists.append(art)
        return artists

    anim = animation.FuncAnimation(fig, draw, frames=len(qs),
                                   interval=1000 // fps, blit=False)
    anim.save(path, writer="pillow", fps=fps)
    plt.close(fig)
    return path


def animate_mesh_3d(model, qs, env=None, path: str = "mesh3d.gif",
                    every: int = 5, fps: int = 20):
    """Mesh-style animation of a floating-base 3D rollout → GIF."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    from .visuals import host, surface

    qs = host(qs)[::every]
    fig = plt.figure(figsize=(6, 5))
    ax = fig.add_subplot(projection="3d")
    c = qs[:, :3].mean(axis=0)
    r = 0.6
    ax.set_xlim(c[0] - r, c[0] + r)
    ax.set_ylim(c[1] - r, c[1] + r)
    ax.set_zlim(0.0, 2 * r)
    gx, gy = np.meshgrid(np.linspace(c[0] - r, c[0] + r, 8),
                         np.linspace(c[1] - r, c[1] + r, 8))
    if env is not None and getattr(env, "dim", 3) == 3:
        gz = surface(env, np.stack([gx.ravel(), gy.ravel()], axis=1)
                     ).reshape(gx.shape)
    else:
        gz = np.zeros_like(gx)
    ax.plot_wireframe(gx, gy, gz, color="0.8", lw=0.5)

    artists: list = []

    def draw(i):
        for a in artists:
            a.remove()
        artists.clear()
        artists.extend(render_robot_3d(model, qs[i], ax))
        return artists

    anim = animation.FuncAnimation(fig, draw, frames=len(qs),
                                   interval=1000 // fps, blit=False)
    anim.save(path, writer="pillow", fps=fps)
    plt.close(fig)
    return path


def render_still(model, q, env=None, path: Optional[str] = None):
    """One mesh-style still frame (2D or 3D dispatch by model family)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from .visuals import host, surface

    q = np.asarray(host(q), float)
    three_d = type(model).__name__ in ("Hopper3D", "CentroidalQuadruped",
                                       "PointFootQuadruped") or \
        type(model).__name__.startswith("Centroidal")
    if three_d:
        fig = plt.figure(figsize=(6, 5))
        ax = fig.add_subplot(projection="3d")
        c = q[:3]
        r = 0.6
        ax.set_xlim(c[0] - r, c[0] + r)
        ax.set_ylim(c[1] - r, c[1] + r)
        ax.set_zlim(0.0, 2 * r)
        render_robot_3d(model, q, ax)
    else:
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.set_aspect("equal")
        ax.set_xlim(q[0] - 1.0, q[0] + 1.0)
        ax.set_ylim(-0.2, 1.5)
        if env is not None:
            xs = np.linspace(q[0] - 1.0, q[0] + 1.0, 200)
            ax.plot(xs, surface(env, xs[:, None]), "k-", lw=1.0)
        else:
            ax.axhline(0.0, color="k", lw=1.0)
        render_robot_2d(model, q, env, ax)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path
    return fig
