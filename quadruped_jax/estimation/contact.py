"""Probabilistic contact + slip detection, batched.

Capability parity with `qrContactDetection`
(quadruped/src/estimators/qr_anomaly_detection.cpp:94-280): fuse four
contact evidence channels per leg through a Kalman filter on the contact
probability —
  * gait-phase prior via erf windows around the stance interval (:105-139);
  * foot-height-vs-ground-plane probability (:151-166);
  * foot vertical-velocity probability exp(-5 |vz|) (:171-206);
  * torque/force evidence: erf of the (external torque proxy) foot force
    against per-leg mean/sigma (:211-216);
and a slip detector: contact legs whose filtered tangential foot velocity is
large are flagged as slipping (:240-266). Hysteresis thresholds on the
posterior reproduce the reference's two-level isContact latch (:225-231).
"""

from __future__ import annotations

import jax.numpy as jnp

from quadruped_jax.core import struct
from quadruped_jax.core.filters import MovingWindowState, moving_window_init, moving_window_update

SIGMA_PHASE = 0.1
SIGMA_PZ = 0.05
TORQUE_MEAN = 20.0   # foot-force midpoint (N) for the force channel
TORQUE_SIGMA = 10.0
THRESH_ENTER = 0.5   # swing -> contact
THRESH_STAY = 0.25   # contact -> swing (hysteresis)
SLIP_THRESH = 0.6


@struct.dataclass
class ContactDetectionState:
    p_contact: jnp.ndarray      # [4] fused posterior
    cov: jnp.ndarray            # [4] per-leg scalar variance
    is_contact: jnp.ndarray     # [4] latched boolean (as float)
    p_slip: jnp.ndarray         # [4]
    is_slip: jnp.ndarray        # [4]
    foot_v_filter: MovingWindowState  # [4, 3] window
    last_vz: jnp.ndarray        # [4]


def contact_detection_init(window: int = 20) -> ContactDetectionState:
    return ContactDetectionState(
        p_contact=jnp.ones(4, jnp.float32),
        cov=jnp.full((4,), 0.1, jnp.float32),
        is_contact=jnp.ones(4, jnp.float32),
        p_slip=jnp.zeros(4, jnp.float32),
        is_slip=jnp.zeros(4, jnp.float32),
        foot_v_filter=moving_window_init(window, (4, 3)),
        last_vz=jnp.zeros(4, jnp.float32),
    )


def jax_erf(x):
    import jax.scipy.special as sps

    return sps.erf(x)


def phase_prior(normalized_phase: jnp.ndarray,
                in_stance: jnp.ndarray) -> jnp.ndarray:
    """Erf window prior (:105-139): high during stance phase, low during
    swing, soft edges of width SIGMA_PHASE."""
    s = SIGMA_PHASE * jnp.sqrt(2.0)
    phi = normalized_phase
    stance_k = 0.5 * (jax_erf(phi / s) + jax_erf((1.0 - phi) / s))
    swing_k = 0.5 * (2.0 + jax_erf(-phi / s) + jax_erf((phi - 1.0) / s))
    return jnp.where(in_stance > 0.5, stance_k, swing_k)


def contact_detection_update(
    state: ContactDetectionState,
    *,
    normalized_phase: jnp.ndarray,   # [4]
    in_stance: jnp.ndarray,          # [4] desired stance (gait clock)
    foot_height_above_ground: jnp.ndarray,  # [4] dz in control frame
    foot_velocities_base: jnp.ndarray,      # [4, 3]
    foot_forces: jnp.ndarray,        # [4] vertical contact force measure
    base_v_control: jnp.ndarray,     # [3] base velocity in control frame
    process_var: float = 0.02,
    sensor_var: float = 0.1,
) -> ContactDetectionState:
    # Channel 0: gait-phase prior (the KF prediction fx).
    prior = phase_prior(normalized_phase, in_stance)

    # Channel 3: height above the fitted plane (:151-166).
    dz = jnp.maximum(foot_height_above_ground, 0.0)
    ppz = 1.0 - jax_erf(dz / (jnp.sqrt(2.0) * SIGMA_PZ / 2))

    # Channel 2: vertical foot velocity (:171-206, method 1).
    vfilt_state, v_filt = moving_window_update(state.foot_v_filter,
                                               foot_velocities_base)
    vz = v_filt[:, 2]
    pvz = jnp.exp(-5.0 * jnp.abs(vz))

    # Channel 1: force/torque evidence (:211-216).
    pforce = 0.5 * (1.0 + jax_erf((foot_forces - TORQUE_MEAN)
                                  / (jnp.sqrt(2.0) * TORQUE_SIGMA)))

    # Scalar KF per leg: predict to the prior, observe the three channels.
    p_pred = prior
    cov_pred = state.cov + process_var
    # Three independent observations with equal variance -> effective
    # measurement = mean, variance / 3.
    z = (pforce + pvz + ppz) / 3.0
    k = cov_pred / (cov_pred + sensor_var / 3.0)
    p_new = jnp.clip(p_pred + k * (z - p_pred), 0.0, 1.0)
    cov_new = (1.0 - k) * cov_pred

    # Hysteresis latch (:225-231).
    thresh = jnp.where(state.is_contact > 0.5, THRESH_STAY, THRESH_ENTER)
    is_contact = (p_new > thresh).astype(jnp.float32)

    # Slip detection (:240-266): tangential foot speed while in contact.
    v_world_foot = v_filt[:, :2] + base_v_control[None, :2]
    pvx = 0.5 * (1.0 + jax_erf(v_world_foot[:, 0] / (jnp.sqrt(2.0) * 0.05)))
    pvy = 0.5 * (1.0 + jax_erf(v_world_foot[:, 1] / (jnp.sqrt(2.0) * 0.05 / 3)))
    p_slip = (0.75 * pvx + 0.25 * pvy) * p_new * is_contact
    is_slip = (p_slip > SLIP_THRESH).astype(jnp.float32)

    return ContactDetectionState(
        p_contact=p_new, cov=cov_new, is_contact=is_contact,
        p_slip=p_slip, is_slip=is_slip, foot_v_filter=vfilt_state,
        last_vz=vz)


def external_knee_torque(params, tau: jnp.ndarray,
                         ddq: jnp.ndarray) -> jnp.ndarray:
    """Reference `qrContactDetection::JointObserver`
    (qr_anomaly_detection.cpp:299-316): the external (contact-induced)
    torque on each knee, estimated from the motor torque minus the free-leg
    dynamics of the calf about the knee:

        tau_ext = I'_yy * ddq_knee + m_calf * g * l_calf - tau_knee

    with I'_yy the calf pitch inertia shifted to the knee by the parallel
    axis theorem (the ctor's transformInertia with p = (0, 0, l_calf),
    :41-47). The hardware-path contact channel is then
    `foot_forces = -external_knee_torque(...)` fed to
    contact_detection_update (the sim path reads contact forces directly).

    tau, ddq: [..., 12] measured joint torques / accelerations.
    Returns [..., 4].
    """
    m_calf = params.links_mass[2]
    l_calf = params.lower_length
    iyy = params.links_inertia[2, 1, 1] + m_calf * l_calf * l_calf
    knee = slice(2, None, 3)
    return iyy * ddq[..., knee] + m_calf * 9.8 * l_calf - tau[..., knee]


def workspace_clip(params, foot_positions_base: jnp.ndarray,
                   allowed: jnp.ndarray):
    """Reference `WorkspaceDetection::Update`
    (qr_anomaly_detection.cpp:319-372): clip foot positions to an allowed
    box centered on (default hip xy, -body_height). The reference's
    sequential per-axis Cohen-Sutherland scalings compose to one scale by
    the minimum axis ratio, which is what this computes (branch-free).

    foot_positions_base: [..., 4, 3]; allowed: [3] box half-extents.
    Returns (clipped positions [..., 4, 3], outside mask [..., 4]).
    """
    offset = params.default_hip_position.at[..., 2].set(-params.body_height)
    p = foot_positions_base - offset
    ratios = allowed / jnp.maximum(jnp.abs(p), 1e-9)
    scale = jnp.minimum(jnp.min(ratios, axis=-1), 1.0)     # [..., 4]
    outside = (scale < 1.0).astype(jnp.float32)
    return offset + p * scale[..., None], outside
