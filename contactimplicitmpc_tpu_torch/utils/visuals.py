"""Trajectory visualization and export.

A copy of ``contactimplicitmpc_tpu/utils/visuals.py`` for the port, the
thin equivalent of the reference's MeshCat stack (``src/visuals.jl``,
``src/dynamics/visuals.jl``): trajectory export and 2D diagnostic plots
(the reference's ``live_plotting``, mpc_utils.jl:156-183), stick-figure
animations written to files on a headless host.

Every function takes numpy arrays or CPU or CUDA tensors, and copies a
tensor to the host once (``host``); the models' kinematics and the
terrains' heights are the port's, evaluated in float64 on the CPU.
Matplotlib is imported lazily, on the Agg backend, so the module stays
importable in plot-free environments.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch


def host(x) -> np.ndarray:
    """``x`` as a numpy array in host memory: a CPU or CUDA tensor is
    copied once."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def kinematics(model, q) -> np.ndarray:
    """The port model's contact points at one configuration ``q`` (nq,),
    float64 on the CPU."""
    return model.kinematics(torch.as_tensor(np.asarray(q, float))).numpy()


def surface(env, x) -> np.ndarray:
    """The port terrain's heights at horizontal points ``x`` (n, ne − 1),
    float64 on the CPU."""
    return env.surf(torch.as_tensor(np.asarray(x, float))).numpy()


def export_trajectory(path: str, traj) -> str:
    """Save a SimTrajectory / MPCRollout / ContactTraj as an .npz archive
    (the build's analog of the JLD2 trajectory artifacts)."""
    data = {k: host(v) for k, v in traj._asdict().items()
            if hasattr(v, "shape")}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **data)
    return path


def plot_tracking(sim_q, ref_q, n_sample: int = 1, coords=None,
                  path: Optional[str] = None, title: str = "tracking"):
    """Configuration tracking vs the (tiled) reference
    (live_plotting, mpc_utils.jl:156-183)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    sim_q = host(sim_q)
    ref_q = host(ref_q)
    coords = list(coords) if coords is not None \
        else list(range(min(4, sim_q.shape[1])))

    fig, axes = plt.subplots(len(coords), 1, figsize=(8, 2 * len(coords)),
                             sharex=True)
    if len(coords) == 1:
        axes = [axes]
    t_sim = np.arange(sim_q.shape[0])
    t_ref = np.arange(ref_q.shape[0]) * n_sample
    for ax, c in zip(axes, coords):
        ax.plot(t_sim, sim_q[:, c], label=f"sim q[{c}]", lw=1.2)
        ax.plot(t_ref, ref_q[:, c], "--", label=f"ref q[{c}]", lw=1.0)
        ax.legend(loc="best", fontsize=8)
    axes[-1].set_xlabel("sim step")
    fig.suptitle(title)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path
    return fig


def plot_contacts(gamma, path: Optional[str] = None,
                  title: str = "contact impulses"):
    """Per-contact normal impulse traces."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    gamma = host(gamma)
    fig, ax = plt.subplots(figsize=(8, 3))
    for i in range(gamma.shape[1]):
        ax.plot(gamma[:, i], label=f"γ[{i}]", lw=1.0)
    ax.set_xlabel("sim step")
    ax.set_ylabel("impulse")
    ax.legend(fontsize=8)
    fig.suptitle(title)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path
    return fig


def skeleton_2d(model, q) -> Sequence[np.ndarray]:
    """Polyline skeleton(s) of a planar model at configuration q, for
    simple stick-figure rendering. Supported: hopper_2d, quadruped,
    flamingo; other models fall back to contact points only."""
    q = host(q)
    name = type(model).__name__
    if name == "Hopper2D":
        body = q[:2]
        foot = kinematics(model, q)[0]
        return [np.stack([body, foot])]
    if name == "Quadruped":
        hip = q[:2]
        torso = hip + model.l_torso * np.array(
            [np.sin(q[2]), -np.cos(q[2])])
        lines = [np.stack([hip, torso])]
        for root, (i_th, i_ca) in ((hip, (3, 4)), (hip, (5, 6)),
                                   (torso, (7, 8)), (torso, (9, 10))):
            knee = root + model.l_thigh * np.array(
                [np.sin(q[i_th]), -np.cos(q[i_th])])
            foot = knee + model.l_calf * np.array(
                [np.sin(q[i_ca]), -np.cos(q[i_ca])])
            lines.append(np.stack([root, knee, foot]))
        return lines
    if name == "Flamingo":
        hip = q[:2]
        torso = hip + model.l_torso * np.array(
            [-np.sin(q[2]), np.cos(q[2])])
        lines = [np.stack([hip, torso])]
        for i_th, i_ca, i_ft in ((3, 4, 7), (5, 6, 8)):
            knee = hip + model.l_thigh * np.array(
                [np.sin(q[i_th]), -np.cos(q[i_th])])
            ankle = knee + model.l_calf * np.array(
                [np.sin(q[i_ca]), -np.cos(q[i_ca])])
            toe = ankle + model.l_foot * np.array(
                [np.sin(q[i_ft]), -np.cos(q[i_ft])])
            heel = ankle - model.d_foot * np.array(
                [np.sin(q[i_ft]), -np.cos(q[i_ft])])
            lines.append(np.stack([hip, knee, ankle]))
            lines.append(np.stack([heel, ankle, toe]))
        return lines
    if name == "PushBot":
        # pole from the origin hinge to its tip (pushbot/visuals.jl)
        th = q[0]
        tip = model.l * np.array([-np.sin(th), np.cos(th)])
        return [np.stack([np.zeros(2), tip])]
    if name == "WalledCartpole":
        # cart at (x, 0), pole to the tip, walls at ±w
        th, x = q[0], q[1]
        cart = np.array([x, 0.0])
        tip = cart + model.l * np.array([-np.sin(th), np.cos(th)])
        wl = np.stack([[-model.w, 0.0], [-model.w, model.l]])
        wr = np.stack([[model.w, 0.0], [model.w, model.l]])
        return [np.stack([cart, tip]), wl, wr]
    k = kinematics(model, q)
    return [k[i:i + 1] for i in range(k.shape[0])]


def feet_3d(model, q) -> np.ndarray:
    """World-frame contact-point positions (n_feet, 3) of a 3D model at
    configuration q, via the model's own kinematics — works for any
    floating-base model (centroidal/point-foot quadrupeds, hopper_3d),
    not just the 18-DoF layout."""
    return kinematics(model, host(q)).reshape(-1, 3)


def skeleton_3d(model, q) -> Sequence[np.ndarray]:
    """3D polyline skeleton for floating-base 3D models (reference
    visuals: src/dynamics/centroidal_quadruped/visuals.jl). Returns
    body→foot segments plus a body orientation triad. Foot positions
    come from ``model.kinematics`` so any 3D model renders."""
    q = host(q)
    body = q[:3]
    feet = feet_3d(model, q)
    lines = [np.stack([body, f]) for f in feet]
    # orientation triad from the MRP (quaternions.jl / mrp.jl)
    p = q[3:6]
    n2 = float(p @ p)
    # MRP → rotation matrix (mrp.jl)
    sk = np.array([[0, -p[2], p[1]], [p[2], 0, -p[0]], [-p[1], p[0], 0.0]])
    rot = np.eye(3) + (8.0 * sk @ sk + 4.0 * (1.0 - n2) * sk) / (1.0 + n2) ** 2
    for axis in rot.T:
        lines.append(np.stack([body, body + 0.1 * axis]))
    return lines


def animate_3d(model, qs, env=None, path: str = "rollout3d.gif",
               every: int = 5, fps: int = 20, gamma=None,
               force_scale: float = 3.0):
    """3D skeleton animation of a floating-base rollout → GIF — the
    minimum MeshCat-class rendering for the 18-DoF models
    (visualize_robot!, src/dynamics/centroidal_quadruped/visuals.jl).
    ``gamma`` (T, nc) overlays vertical contact-force arrows at the feet
    (visualize_force! parity)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    qs = host(qs)[::every]
    gamma = None if gamma is None else host(gamma)[::every]
    fig = plt.figure(figsize=(6, 5))
    ax = fig.add_subplot(projection="3d")
    c = qs[:, :3].mean(axis=0)
    r = 0.6
    ax.set_xlim(c[0] - r, c[0] + r)
    ax.set_ylim(c[1] - r, c[1] + r)
    ax.set_zlim(0.0, 2 * r)
    # ground plane grid
    gx, gy = np.meshgrid(np.linspace(c[0] - r, c[0] + r, 8),
                         np.linspace(c[1] - r, c[1] + r, 8))
    if env is not None and getattr(env, "dim", 3) == 3:
        gz = surface(env, np.stack([gx.ravel(), gy.ravel()], axis=1)
                     ).reshape(gx.shape)
    else:
        gz = np.zeros_like(gx)
    ax.plot_wireframe(gx, gy, gz, color="0.8", lw=0.5)

    artists = []

    def draw(i):
        for a in artists:
            a.remove()
        artists.clear()
        for j, line in enumerate(skeleton_3d(model, qs[i])):
            color = "C0" if j < 4 else "C3"
            (art,) = ax.plot(line[:, 0], line[:, 1], line[:, 2], "o-",
                             color=color, lw=2.0, ms=3)
            artists.append(art)
        if gamma is not None and i < len(gamma):
            feet = feet_3d(model, qs[i])
            nf = feet.shape[0]
            g = gamma[i].reshape(-1)[:nf]
            art = ax.quiver(feet[:, 0], feet[:, 1], feet[:, 2],
                            np.zeros(nf), np.zeros(nf), g * force_scale,
                            color="C3", lw=1.5)
            artists.append(art)
        return artists

    anim = animation.FuncAnimation(fig, draw, frames=len(qs),
                                   interval=1000 // fps, blit=False)
    anim.save(path, writer="pillow", fps=fps)
    plt.close(fig)
    return path


def contact_force_vectors(model, q, gamma, b=None):
    """Per-contact world-frame force vectors at the feet for overlay
    rendering (visualize_force!, src/visuals.jl:61-94): vertical = normal
    impulse γ, horizontal = net linearized friction b⁺ − b⁻."""
    k = kinematics(model, host(q))
    nc = k.shape[0]
    gamma = host(gamma).reshape(nc)
    vecs = np.zeros((nc, 2))
    vecs[:, 1] = gamma
    if b is not None:
        b = host(b).reshape(nc, -1)
        vecs[:, 0] = b[:, 0] - b[:, 1]
    return k[:, :2], vecs


def animate_2d(model, qs, env=None, path: str = "rollout.gif",
               every: int = 5, fps: int = 20, gamma=None, b=None,
               w=None, payload: float = 0.0, force_scale: float = 3.0):
    """Stick-figure animation of a planar rollout → GIF
    (visualize_robot! equivalent, src/visuals.jl:18-60).

    Overlays (per-robot visuals parity, src/visuals.jl:61-146):

    * ``gamma``/``b`` — (T, nc)/(T, nb) contact impulses drawn as force
      arrows at the feet (``visualize_force!``)
    * ``w`` — (T, nw) disturbance drawn as an arrow at the base
      (``visualize_disturbance!``)
    * ``payload`` — payload mass drawn as a marker on the torso
      (``visualize_payload!``)

    Impulse arrays are indexed at the same sim steps as ``qs`` (arrays
    are strided by ``every`` internally; pass them un-strided).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    qs = host(qs)[::every]
    gamma = None if gamma is None else host(gamma)[::every]
    b = None if b is None else host(b)[::every]
    w = None if w is None else host(w)[::every]
    fig, ax = plt.subplots(figsize=(6, 4))
    xmin, xmax = qs[:, 0].min() - 1.0, qs[:, 0].max() + 1.0
    ax.set_xlim(xmin, xmax)
    ax.set_ylim(-0.2, 1.5)
    ax.set_aspect("equal")
    if env is not None:
        xs = np.linspace(xmin, xmax, 200)
        ys = surface(env, xs[:, None])
        ax.plot(xs, ys, "k-", lw=1.0)
    else:
        ax.axhline(0.0, color="k", lw=1.0)

    artists = []

    def draw(i):
        for a in artists:
            a.remove()
        artists.clear()
        for line in skeleton_2d(model, qs[i]):
            (art,) = ax.plot(line[:, 0], line[:, 1], "o-", color="C0",
                             lw=2.0, ms=3)
            artists.append(art)
        if gamma is not None and i < len(gamma):
            pts, vecs = contact_force_vectors(
                model, qs[i], gamma[i], None if b is None else b[i])
            art = ax.quiver(pts[:, 0], pts[:, 1], vecs[:, 0], vecs[:, 1],
                            angles="xy", scale_units="xy",
                            scale=1.0 / force_scale, color="C3",
                            width=4e-3)
            artists.append(art)
        if w is not None and i < len(w) and np.any(w[i] != 0.0):
            art = ax.quiver(qs[i, 0], qs[i, 1], float(w[i][0]),
                            float(w[i][1]) if w.shape[1] > 1 else 0.0,
                            angles="xy", scale_units="xy",
                            scale=1.0 / force_scale, color="C1",
                            width=6e-3)
            artists.append(art)
        if payload > 0.0:
            (art,) = ax.plot([qs[i, 0]], [qs[i, 1]], "s", color="C2",
                             ms=4 + 2 * payload)
            artists.append(art)
        return artists

    anim = animation.FuncAnimation(fig, draw, frames=len(qs),
                                   interval=1000 // fps, blit=False)
    anim.save(path, writer="pillow", fps=fps)
    plt.close(fig)
    return path


def runs_2d_lines(model, qs_batch, stride: int = 100):
    """The skeletons ``plot_runs_2d`` draws: (lane, polyline) for every
    ``stride``-th pose of every lane of ``qs_batch`` (B, T, nq)."""
    return [(lane, line) for lane, qs in enumerate(host(qs_batch))
            for q in qs[::stride] for line in skeleton_2d(model, q)]


def plot_runs_2d(model, qs_batch, env=None, path: str = "runs.png",
                 stride: int = 100):
    """Overlaid transparent robot poses across a batch of rollouts — the
    Monte-Carlo sweep figure (visualize_runs!,
    examples/hopper/monte_carlo.jl:94-116), one matplotlib still instead
    of a MeshCat scene."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    qs_batch = host(qs_batch)
    fig, ax = plt.subplots(figsize=(8, 4))
    xmin = qs_batch[..., 0].min() - 0.5
    xmax = qs_batch[..., 0].max() + 0.5
    ax.set_xlim(xmin, xmax)
    ax.set_ylim(-0.2, 1.6)
    ax.set_aspect("equal")
    if env is not None:
        xs = np.linspace(xmin, xmax, 300)
        ax.plot(xs, surface(env, xs[:, None]), "k-", lw=1.0)
    else:
        ax.axhline(0.0, color="k", lw=1.0)
    alpha = min(1.0, 5.0 * max(0.04, 1.0 / len(qs_batch)))
    for lane, line in runs_2d_lines(model, qs_batch, stride):
        ax.plot(line[:, 0], line[:, 1], "-", color=f"C{lane % 10}",
                lw=1.2, alpha=alpha)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
