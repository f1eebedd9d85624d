"""Mixed-integer QP baseline on the wall pendulum, on the PyTorch port — the
paper's "MIQP vs contact-implicit MPC" comparison experiment; the
counterpart of examples/miqp_wallpendulum.py.

Mirror of the reference's ``examples/miqp/miqp.jl`` +
``methods/structures.jl``: a pendulum between two spring walls has three
piecewise-affine contact modes (none / left wall / right wall), each a box
domain in (θ, θ̇) with its own affine dynamics (A_i, B_i, c_i). The
reference solves the hybrid MPC as a big-M mixed-integer QP with Gurobi;
this build solves the same hybrid program by batched explicit enumeration,
as the JAX example does:

* enumerate mode sequences over the MPC horizon with at most
  ``max_switches`` mode changes,
* for every sequence, condense the affine dynamics and solve the resulting
  QP in closed form — the same algebra as the JAX example's ``vmap``, here
  as tensors with a leading sequence axis, one batched ``torch.linalg.
  solve`` over all sequences at once,
* sequences whose optimal trajectory leaves their mode domains get an
  infeasibility penalty, and the argmin over the batch is the MIQP optimum
  over the restricted schedule set.

Problem data (T, dt, Q, Qf, R, β, disturbance schedule) follows
miqp.jl:20-58 with a receding-horizon T suited to enumeration. Float64.

Run: python examples/torch_miqp_wallpendulum.py [--steps 380]
     [--horizon 20] [--cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_wall_pendulum(dt, mp=1.0, l=1.0, g=10.0, k=1e4, d=0.1):
    """Piecewise-affine wall-pendulum data (structures.jl:15-38):
    mode 0 = no contact, 1 = left wall, 2 = right wall."""
    import numpy as np

    B = dt * np.array([[0.0], [1.0 / (mp * l ** 2)]])
    A_free = np.eye(2) + dt * np.array([[0.0, 1.0], [g / l, 0.0]])
    A_wall = np.eye(2) + dt * np.array([[0.0, 1.0],
                                        [g / l - k / mp, 0.0]])
    c0 = np.zeros(2)
    c1 = dt * np.array([0.0, k * d / (mp * l)])
    c2 = dt * np.array([0.0, -k * d / (mp * l)])
    A = np.stack([A_free, A_wall, A_wall])
    Bs = np.stack([B, B, B])
    c = np.stack([c0, c1, c2])
    # box domains (structures.jl:100-130): θ in units of d/l
    th = d / l
    x_lo = np.array([[-th, -1.5], [th, -1.5], [-2 * th, -1.5]])
    x_hi = np.array([[th, 1.5], [2 * th, 1.5], [-th, 1.5]])
    u_lim = 4.0
    return A, Bs, c, x_lo, x_hi, u_lim, th


def mode_sequences(T, n_modes=3, max_switches=2, switch_window=None):
    """All mode sequences with ≤ max_switches changes — the contact
    schedules a pendulum can actually execute over a short horizon.
    ``switch_window`` restricts switch stages to the first k steps (a
    receding-horizon controller only needs near-term contact timing
    resolved; the tail mode holds), keeping enumeration O(k²)."""
    import numpy as np

    k = T if switch_window is None else min(T, switch_window)
    seqs = set()
    for m0 in range(n_modes):
        seqs.add((m0,) * T)
    for s1 in range(1, k):
        for m0 in range(n_modes):
            for m1 in range(n_modes):
                if m1 == m0:
                    continue
                seqs.add((m0,) * s1 + (m1,) * (T - s1))
                if max_switches >= 2:
                    for s2 in range(s1 + 1, k):
                        for m2 in range(n_modes):
                            if m2 == m1:
                                continue
                            seqs.add((m0,) * s1 + (m1,) * (s2 - s1)
                                     + (m2,) * (T - s2))
    return np.array(sorted(seqs), dtype=np.int32)


def make_wall_mpc(T=10, dt=0.04, Q=1.0, Qf=50.0, R=1.0, beta=1e3,
                  device=None):
    """Build (mpc_step, sim_step, th, n_seq) for the wall-pendulum hybrid
    MPC on ``device`` (by default the GPU), float64 — module-level so tests
    and analysis reuse the controller. ``mpc_step(x0)`` takes the state
    (2,) and returns the first control and its cost, 0-dim tensors;
    ``sim_step(x, u)`` takes one true-mode step."""
    import torch

    from contactimplicitmpc_tpu_torch.device import resolve_device

    device = resolve_device(device)
    f64 = dict(dtype=torch.float64, device=device)
    A, B, c, x_lo, x_hi, u_lim, th = build_wall_pendulum(dt)
    seqs = torch.as_tensor(mode_sequences(T, switch_window=12),
                           dtype=torch.long, device=device)
    A_t, B_t, c_t = (torch.as_tensor(x, **f64) for x in (A, B[:, :, 0], c))
    xlo_t, xhi_t = (torch.as_tensor(x, **f64) for x in (x_lo, x_hi))
    eye = torch.eye(T, **f64)
    tri = torch.arange(T, device=device)[:, None] >= torch.arange(
        T, device=device)[None, :]
    w = torch.cat([torch.full((T - 1,), Q, **f64),
                   torch.tensor([Qf], **f64)])
    # stiff hinge: the mode dynamics jump discontinuously at the box
    # boundary (the wall spring constant k=1e4 enters c as a ±40 velocity
    # offset per step), so the penalty must act as a hard constraint; the
    # reference's β=1e3 is Gurobi's big-M magnitude, scaled up by ~1e4 to
    # be boundary-stiff at this problem's units
    beta_q = 1.0e4 * beta

    # the condensed rollout of every sequence (S sequences, T stages):
    # x_t = M_t x0 + Σ_s G[t, s] u_s + g_t, M_t = A_t ... A_0
    As, Bs, cs = A_t[seqs], B_t[seqs], c_t[seqs]     # (S, T, 2, 2), (S, T, 2)
    n_seq = seqs.shape[0]
    M = torch.eye(2, **f64).expand(n_seq, 2, 2)
    g = torch.zeros((n_seq, 2), **f64)
    Ms, gs = [], []
    for t in range(T):
        M = As[:, t] @ M
        g = (As[:, t] @ g[:, :, None])[:, :, 0] + cs[:, t]
        Ms.append(M)
        gs.append(g)
    Ms, gs = torch.stack(Ms, dim=1), torch.stack(gs, dim=1)
    # G[t, s] = Φ(t) Φ(s)⁻¹ B_s with Φ(t) = Ms[t], the 2 × 2 inverse in
    # closed form
    det = Ms[..., 0, 0] * Ms[..., 1, 1] - Ms[..., 0, 1] * Ms[..., 1, 0]
    inv = torch.stack([torch.stack([Ms[..., 1, 1], -Ms[..., 0, 1]], -1),
                       torch.stack([-Ms[..., 1, 0], Ms[..., 0, 0]], -1)],
                      -2) / det[..., None, None]
    V = (inv @ Bs[..., None])[..., 0]                # (S, T, 2)
    G = torch.where(tri[None, :, :, None],
                    torch.einsum("btij,bsj->btsi", Ms, V), 0.0)
    # (x_t, u_t) ∈ C_{m_t}: row t of xs is x_{t+1}, governed by mode
    # seq[t+1] (the terminal state reuses the last stage's box)
    seq_next = torch.cat([seqs[:, 1:], seqs[:, -1:]], dim=1)
    lo, hi = xlo_t[seq_next], xhi_t[seq_next]         # (S, T, 2)
    # G with its rows (t, i) flattened, (S, 2T, T), so that every sum over
    # stages is one batched matmul
    Gf = G.permute(0, 1, 3, 2).reshape(n_seq, 2 * T, T)
    Gt = Gf.transpose(1, 2)
    wf = w.repeat_interleave(2)[None, :, None]        # (1, 2T, 1)
    H0 = R * eye + Gt @ (wf * Gf)
    reg = 1e-9 * eye

    def solve(H, b):
        return torch.clamp(-torch.linalg.solve(H + reg, b), -u_lim, u_lim)

    def mpc_step(x0):
        """Every sequence's QP at the state ``x0``; the argmin's first
        control and cost."""
        xb = (Ms @ x0) + gs                              # (S, T, 2)
        xbf = xb.reshape(n_seq, 2 * T, 1)
        b0 = (Gt @ (wf * xbf))[..., 0]
        u = solve(H0, b0)
        # masked active-set Newton passes on the β-weighted quadratic
        # hinge that keeps every stage inside its mode's box
        for _ in range(6):
            xs = xb + (Gf @ u[..., None]).reshape(n_seq, T, 2)
            wa = beta_q * ((xs < lo) | (xs > hi)).to(xs.dtype)
            tgt = torch.clamp(xs, lo, hi)
            waf = wa.reshape(n_seq, 2 * T, 1)
            H = H0 + Gt @ (waf * Gf)
            b = b0 + (Gt @ (waf * (xb - tgt).reshape(n_seq, 2 * T, 1)))[..., 0]
            u = solve(H, b)
        xs = xb + (Gf @ u[..., None]).reshape(n_seq, T, 2)
        cost = (w * (xs * xs).sum(-1)).sum(-1) + R * (u * u).sum(-1)
        vio = (torch.relu(lo - xs) + torch.relu(xs - hi)).sum((-2, -1))
        # initial state feasibility for mode seq[0]
        vio = vio + (torch.relu(xlo_t[seqs[:, 0]] - x0)
                     + torch.relu(x0 - xhi_t[seqs[:, 0]])).sum(-1)
        # infeasible sequences are rejected outright (vio as tiebreak so
        # a least-infeasible fallback exists if every schedule fails)
        cost = torch.where(vio > 1e-3, 1e9 * (1.0 + vio), cost)
        i = torch.argmin(cost)
        return u[i, 0], cost[i]

    def sim_step(x, u):
        m = torch.where(x[0] > th, 1, torch.where(x[0] < -th, 2, 0))
        return A_t[m] @ x + B_t[m] * u + c_t[m]

    return mpc_step, sim_step, th, n_seq


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=380)
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from contactimplicitmpc_tpu_torch.device import describe, resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    tag = f"[{describe(device)}]"
    dt = 0.04                      # miqp.jl:22
    T = args.horizon               # receding horizon (enumeration-sized)
    Q, Qf, R, beta = 1.0, 50.0, 1.0, 1e3   # miqp.jl:24-27
    mpc_step, sim_step, th, n_seq = make_wall_mpc(T, dt, Q, Qf, R, beta,
                                                  device=device)
    print(f"wall pendulum MIQP: horizon {T}, {n_seq} mode sequences "
          f"(≤2 switches), dt={dt} {tag}")

    # disturbance schedule (miqp.jl:44-52): impulsive θ̇ kicks
    dist = {20: -15.5, 120: 15.5, 160: 15.5, 260: -11.5, 320: -10.5}

    x = torch.zeros(2, dtype=torch.float64, device=device)
    xs_out, solve_times = [x.cpu().numpy()], []
    # warm up before timing (the reference reports warm solve times)
    float(mpc_step(x)[0])
    for t in range(args.steps):
        if t in dist:
            x = x + torch.tensor([0.0, dist[t] * dt], dtype=x.dtype,
                                 device=device)  # impulse → velocity jump
        t0 = time.time()
        u = float(mpc_step(x)[0])
        solve_times.append(time.time() - t0)
        x = sim_step(x, u)
        xs_out.append(x.cpu().numpy())

    xs_out = np.stack(xs_out)
    st = np.array(solve_times)
    # miqp.jl:61-64 reporting: mean/max solve time vs the control period
    print(f"solve time: mean {st.mean() * 1e3:.2f} ms, "
          f"max {st.max() * 1e3:.2f} ms "
          f"(control period {dt * 1e3:.0f} ms; "
          f"speed ratio {dt / st.mean():.2f}x) {tag}")
    print(f"|θ| final {abs(xs_out[-1, 0]):.4f}, "
          f"max |θ| {np.abs(xs_out[:, 0]).max():.4f} "
          f"(wall at {th:.2f}, domain edge {2 * th:.2f})")
    ok = abs(xs_out[-1, 0]) < 0.05 and np.abs(xs_out[:, 0]).max() < 0.21
    print(f"recovered upright through {len(dist)} pushes: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
