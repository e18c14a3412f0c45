"""Flow-matching sampling (counterpart of cake_tpu/ops/diffusion.py:
flux_time_shift, flow_matching_schedule, flow_matching_euler_step,
cfg_combine; its DPM-Solver++ serves SD and audio, not ported yet).

The schedule is host-side numpy, as in the reference: step counts are
small and static, and the model call dominates.
"""
from __future__ import annotations

import numpy as np


def flux_time_shift(t: np.ndarray, mu: float = 1.15, sigma: float = 1.0):
    """FLUX resolution-dependent timestep shift:
    exp(mu) / (exp(mu) + (1/t - 1)^sigma)."""
    return np.exp(mu) / (np.exp(mu) + (1.0 / t - 1.0) ** sigma)


def flow_matching_schedule(steps: int, shift_mu: float | None = None):
    """Linear t: 1 -> 0 timesteps (steps + 1 points), optionally
    FLUX-shifted, as float32."""
    t = np.linspace(1.0, 0.0, steps + 1)
    if shift_mu is not None:
        valid = t > 0
        t = np.where(valid, flux_time_shift(np.clip(t, 1e-5, 1.0), shift_mu),
                     0.0)
    return t.astype(np.float32)


def flow_matching_euler_step(x, velocity, t_cur: float, t_next: float):
    """x_{t_next} = x + (t_next - t_cur) * v (velocity parameterization).
    Pass Python floats: a numpy scalar would promote bf16 latents."""
    return x + (t_next - t_cur) * velocity


def cfg_combine(uncond, cond, scale: float):
    """Classifier-free guidance."""
    return uncond + scale * (cond - uncond)
