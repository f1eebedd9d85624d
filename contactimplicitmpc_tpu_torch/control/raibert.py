"""Raibert heuristic hopping policies — the paper's classical comparison
baseline (the reference's ``examples/raibert/policy/2D.jl`` and ``3D.jl``).

PyTorch counterpart of ``contactimplicitmpc_tpu/control/raibert.py``:
two-phase (stance/flight) PD controllers, branchless (``torch.where``
picks the phase) and elementwise over a leading batch of lanes. Contact is
detected from the previous step's impact impulse (any γ above 1.5e-2,
2D.jl:52-56). They plug into ``sim.simulator.simulate`` through its
``(init_state(batch), apply)`` policy form.
"""

from __future__ import annotations

import math

import torch

from ..models.rotations import mrp_rotation_matrix


def raibert_policy(model, h: float, v0: float = 0.5,
                   t_stance: float = 0.13, t_flight: float = 0.62,
                   r_ref: float = 0.5,
                   kr_c: float = 8e1, kr_p: float = -1e3,
                   kr_v_stance: float = -1e-2, kr_v_flight: float = -1e1,
                   ktheta_c: float = 0.0, ktheta_p: float = -3e1,
                   ktheta_v: float = -1e1,
                   contact_threshold: float = 1.5e-2):
    """The 2D hopper's policy, gains and defaults from raibert_policy
    (2D.jl:24-43); ``h`` is the SIM step (the reference reads ``traj.h`` at
    apply time, 2D.jl:47). Returns the ``(init_state, apply)`` pair for
    ``simulate``."""
    theta_td = math.asin(v0 * t_stance / (2.0 * r_ref)) / 2.0
    flight_ratio = t_flight / t_stance

    def init_state(batch):
        return ()

    def apply(state, obs):
        contact = torch.any(obs.gamma > contact_threshold, dim=-1)
        qv = (obs.q1 - obs.q0) / h
        theta_v, r_v = qv[:, 2], qv[:, 3]
        theta1, r1 = obs.q1[:, 2], obs.q1[:, 3]

        # stance: regulate θ about −θtd with the flight/stance time-ratio
        # boost; flight: PD about +θtd (2D.jl:80-89)
        u_theta_stance = ktheta_c + ktheta_p * (theta1 + theta_td) * \
            flight_ratio
        u_theta_flight = ktheta_p * (theta1 - theta_td) + ktheta_v * theta_v
        u_r_stance = kr_c + kr_p * (r1 - r_ref) + kr_v_stance * r_v
        u_r_flight = kr_p * (r1 - r_ref) + kr_v_flight * r_v

        u = torch.stack([
            torch.where(contact, u_theta_stance, u_theta_flight),
            torch.where(contact, u_r_stance, u_r_flight)], dim=-1)
        return u * h, state  # impulse scaling (2D.jl:91)

    return init_state, apply


def mrp_to_euler_xyz(p):
    """XYZ Euler angles (θ1, θ2, θ3) of the MRP rotation over the last
    axis — the branchless analog of ``RotXYZ(MRP(...))`` (3D.jl:59-63).
    Convention R = Rx(θ1)·Ry(θ2)·Rz(θ3), so θ2 = asin(R[0,2]),
    θ1 = atan2(−R[1,2], R[2,2]), θ3 = atan2(−R[0,1], R[0,0])."""
    r = mrp_rotation_matrix(p)
    t2 = torch.asin(torch.clamp(r[..., 0, 2], -1.0, 1.0))
    t1 = torch.atan2(-r[..., 1, 2], r[..., 2, 2])
    t3 = torch.atan2(-r[..., 0, 1], r[..., 0, 0])
    return torch.stack([t1, t2, t3], dim=-1)


def raibert_policy_3d(model, h: float, v0=(0.0, 0.2),
                      t_stance: float = 0.13, t_flight: float = 0.62,
                      r_ref: float = 0.5,
                      kr_c: float = 8e1, kr_p: float = -1e3,
                      kr_v_stance: float = -1e-2,
                      kr_v_flight: float = -1e1,
                      ktheta_c: float = 0.0, ktheta_p: float = -6e1,
                      ktheta_v: float = -1e1,
                      contact_threshold: float = 1.5e-2):
    """The 3D hopper's policy — gains and two-phase structure from
    raibert_policy / Raibert3D (3D.jl:27-110), with a safe-normalized
    velocity direction. q = (xyz, MRP, r); u = (roll torque, pitch torque,
    leg force)."""
    td_x, td_y = (math.asin(v * t_stance / (2.0 * r_ref)) / 2.0 for v in v0)
    flight_ratio = t_flight / t_stance

    def init_state(batch):
        return ()

    def apply(state, obs):
        contact = torch.any(obs.gamma > contact_threshold, dim=-1)
        qv = (obs.q1 - obs.q0) / h
        eul0 = mrp_to_euler_xyz(obs.q0[:, 3:6])
        eul1 = mrp_to_euler_xyz(obs.q1[:, 3:6])
        theta_v = (eul1 - eul0) / h
        r_v, r1 = qv[:, 6], obs.q1[:, 6]

        # normalized planar heading (3D.jl:94, safe at rest)
        vxy = qv[:, :2]
        nrm = torch.sqrt(torch.sum(vxy * vxy, dim=-1, keepdim=True))
        dir_ = torch.where(nrm > 1e-8, vxy / torch.clamp(nrm, min=1e-8),
                           torch.zeros_like(vxy))
        dx, dy = dir_[:, 0], dir_[:, 1]

        # stance (3D.jl:97-100): servo Euler angles toward the
        # direction-signed touchdown angles with the flight/stance boost
        u1_st = dy * ktheta_c + ktheta_p * (eul1[:, 0] + dy * td_x) * \
            flight_ratio
        u2_st = dx * ktheta_c + ktheta_p * (eul1[:, 1] + dx * td_y) * \
            flight_ratio
        u3_st = kr_c + kr_p * (r1 - r_ref) + kr_v_stance * r_v
        # flight (3D.jl:102-106)
        u1_fl = ktheta_p * (eul1[:, 0] - dy * td_x) + ktheta_v * theta_v[:, 0]
        u2_fl = ktheta_p * (eul1[:, 1] - dx * td_y) + ktheta_v * theta_v[:, 1]
        u3_fl = kr_p * (r1 - r_ref) + kr_v_flight * r_v

        u = torch.stack([torch.where(contact, u1_st, u1_fl),
                         torch.where(contact, u2_st, u2_fl),
                         torch.where(contact, u3_st, u3_fl)], dim=-1)
        return u * h, state  # impulse scaling (3D.jl:108)

    return init_state, apply
