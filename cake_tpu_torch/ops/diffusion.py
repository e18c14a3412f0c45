"""Diffusion samplers (counterpart of cake_tpu/ops/diffusion.py:
flux_time_shift, flow_matching_schedule, flow_matching_euler_step,
cfg_combine, DpmSolverPP): FLUX's flow-matching Euler steps and SD's
DPM-Solver++(2M) over a trained discrete schedule.

The schedules are host-side numpy, as in the reference: step counts are
small and static, and the model call dominates. Every coefficient that
meets a latent is a Python float, so bf16 latents stay bf16 (a numpy
scalar would promote them).
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


class DpmSolverPP:
    """DPM-Solver++(2M) over a trained discrete schedule.

    alphas_cumprod: the full training schedule (e.g. 1000 steps);
    `timesteps(n)` picks n inference steps; `step` consumes the model's
    outputs in order (epsilon, v_prediction or sample), keeping the
    previous x0 for the second-order update: one solver per sequence.
    """

    def __init__(self, alphas_cumprod: np.ndarray,
                 prediction_type: str = "v_prediction"):
        self.alphas_cumprod = np.asarray(alphas_cumprod, np.float64)
        self.T = len(self.alphas_cumprod)
        self.prediction_type = prediction_type
        self._last_x0 = None
        self._last_lambda = None

    @classmethod
    def from_betas(cls, beta_start=0.00085, beta_end=0.012, n=1000,
                   schedule="scaled_linear", **kw):
        if schedule == "scaled_linear":
            betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, n) ** 2
        elif schedule == "linear":
            betas = np.linspace(beta_start, beta_end, n)
        elif schedule == "squaredcos_cap_v2":
            return cls.from_cosine(n=n, **kw)
        else:
            # a silently wrong noise schedule makes garbage images with no
            # diagnostic
            raise NotImplementedError(f"beta schedule {schedule!r}")
        return cls(np.cumprod(1.0 - betas), **kw)

    @classmethod
    def from_cosine(cls, n=1000, s=0.008, max_beta=0.999, **kw):
        """The squaredcos_cap_v2 schedule."""
        def f(t):
            return np.cos((t / n + s) / (1 + s) * np.pi / 2) ** 2
        t = np.arange(n)
        betas = np.clip(1.0 - f(t + 1) / f(t), 0.0, max_beta)
        return cls(np.cumprod(1.0 - betas), **kw)

    def timesteps(self, steps: int) -> np.ndarray:
        return np.linspace(self.T - 1, 0, steps).round().astype(np.int64)

    def _coeffs(self, t: int):
        a = float(self.alphas_cumprod[t])
        alpha_t = float(a ** 0.5)
        sigma_t = float((1.0 - a) ** 0.5)
        lam = float(np.log(alpha_t) - np.log(sigma_t))
        return alpha_t, sigma_t, lam

    def _to_x0(self, model_out, x, t: int):
        alpha_t, sigma_t, _ = self._coeffs(t)
        if self.prediction_type == "epsilon":
            return (x - sigma_t * model_out) / alpha_t
        if self.prediction_type == "v_prediction":
            return alpha_t * x - sigma_t * model_out
        return model_out                # "sample"

    def step(self, model_out, t: int, t_next: int, x):
        """One DPM-Solver++(2M) update, multistep with the previous x0."""
        x0 = self._to_x0(model_out, x, t)
        alpha_s, sigma_s, lam_s = self._coeffs(t)
        if t_next <= 0:
            out = x0
        else:
            alpha_t, sigma_t, lam_t = self._coeffs(t_next)
            h = lam_t - lam_s
            r = float(np.exp(-h))
            if self._last_x0 is None:
                d = x0
            else:
                h_last = lam_s - self._last_lambda
                r0 = h_last / h if h != 0 else 1.0
                d = (1 + 1 / (2 * r0)) * x0 - (1 / (2 * r0)) * self._last_x0
            out = (sigma_t / sigma_s) * r * x + alpha_t * (1 - r) * d
        self._last_x0 = x0
        self._last_lambda = lam_s
        return out
