"""Diffusion noise schedule and samplers (counterpart of
`mm_interleaved_tpu/models/sd/scheduler.py`): ancestral DDPM over a strided
("leading") timestep subset, and DDIM.  Tables are fp32, and the step
arithmetic runs on fp32 scalars as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"  # or "v_prediction"

    def betas(self) -> torch.Tensor:
        if self.beta_schedule == "scaled_linear":
            return torch.linspace(self.beta_start ** 0.5, self.beta_end ** 0.5,
                                  self.num_train_timesteps,
                                  dtype=torch.float32) ** 2
        if self.beta_schedule == "linear":
            return torch.linspace(self.beta_start, self.beta_end,
                                  self.num_train_timesteps,
                                  dtype=torch.float32)
        raise ValueError(self.beta_schedule)

    def alphas_cumprod(self) -> torch.Tensor:
        return torch.cumprod(1.0 - self.betas(), dim=0)

    # training

    def _coefs(self, timesteps, like):
        ac = self.alphas_cumprod().to(like.device)[timesteps.long()]
        a = torch.sqrt(ac)[:, None, None, None]
        s = torch.sqrt(1.0 - ac)[:, None, None, None]
        return a, s

    def add_noise(self, latents, noise, timesteps):
        a, s = self._coefs(timesteps, latents)
        return a * latents + s * noise

    def get_velocity(self, latents, noise, timesteps):
        a, s = self._coefs(timesteps, latents)
        return a * noise - s * latents

    def training_target(self, latents, noise, timesteps):
        if self.prediction_type == "epsilon":
            return noise
        if self.prediction_type == "v_prediction":
            return self.get_velocity(latents, noise, timesteps)
        raise ValueError(self.prediction_type)

    # sampling

    def inference_timesteps(self, num_inference_steps: int) -> List[int]:
        """Strided timesteps, descending (diffusers "leading" spacing)."""
        step = self.num_train_timesteps // num_inference_steps
        return [i * step for i in range(num_inference_steps)][::-1]

    def _alphas(self, t: int, t_prev: int):
        ac = self.alphas_cumprod()
        a_t = ac[t]
        a_prev = ac[t_prev] if t_prev >= 0 else torch.tensor(1.0)
        return a_t, a_prev

    def _pred_x0_eps(self, model_out, sample, a_t):
        sq_a = torch.sqrt(a_t).to(sample.device)
        sq_1ma = torch.sqrt(1.0 - a_t).to(sample.device)
        if self.prediction_type == "epsilon":
            eps = model_out
            x0 = (sample - sq_1ma * eps) / sq_a
        elif self.prediction_type == "v_prediction":
            x0 = sq_a * sample - sq_1ma * model_out
            eps = sq_a * model_out + sq_1ma * sample
        else:
            raise ValueError(self.prediction_type)
        return x0, eps

    def ddpm_step(self, model_out, t: int, t_prev: int, sample, noise):
        """One ancestral DDPM step from ``t`` to ``t_prev`` (no noise when
        ``t_prev < 0``)."""
        a_t, a_prev = self._alphas(t, t_prev)
        x0, _ = self._pred_x0_eps(model_out, sample, a_t)
        x0 = x0.clamp(-1e4, 1e4)
        alpha_t = a_t / a_prev
        beta_t = 1.0 - alpha_t
        dev = sample.device
        coef_x0 = (torch.sqrt(a_prev) * beta_t / (1.0 - a_t)).to(dev)
        coef_xt = (torch.sqrt(alpha_t) * (1.0 - a_prev) / (1.0 - a_t)).to(dev)
        mean = coef_x0 * x0 + coef_xt * sample
        if t_prev < 0:
            return mean
        var = (beta_t * (1.0 - a_prev) / (1.0 - a_t)).clamp(min=1e-20)
        return mean + torch.sqrt(var).to(dev) * noise

    def ddim_step(self, model_out, t: int, t_prev: int, sample):
        a_t, a_prev = self._alphas(t, t_prev)
        x0, eps = self._pred_x0_eps(model_out, sample, a_t)
        dev = sample.device
        return (torch.sqrt(a_prev).to(dev) * x0
                + torch.sqrt(1.0 - a_prev).to(dev) * eps)
