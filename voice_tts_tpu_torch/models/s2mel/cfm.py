"""Conditional flow matching: Euler ODE solve with classifier-free guidance
(`voice_tts_tpu/models/s2mel/cfm.py`).

Noise init, prompt region pinned to zero, uniform t_span, per-step CFG on a
stacked [real; null] batch, `(1 + r) * v - r * v_null`, prompt region
re-zeroed after every step.  A Python loop replaces the JAX `lax.scan`; it
reads nothing back to the host, so the engine runs the whole solve as one
CUDA graph on the card (`engine.device_loop.run_once`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def cfm_inference(velocity: Callable, mu: torch.Tensor, x_len: torch.Tensor,
                  prompt: torch.Tensor, prompt_len: torch.Tensor,
                  style: torch.Tensor, n_steps: int, cfg_rate: float,
                  generator: Optional[torch.Generator] = None,
                  temperature: float = 1.0,
                  noise: Optional[torch.Tensor] = None,
                  tables: Optional[Callable[[int], dict]] = None) -> torch.Tensor:
    """mu (B, T, D) regulated condition; prompt (B, 80, T) with the reference
    mel at [:prompt_len] (zero elsewhere); x_len (B,) total valid frames.

    `velocity(x, prompt, x_len, t, style, mu, tab)` evaluates the DiT;
    `tables(i)` returns step i's precomputed tables (or None).  `noise`
    (B, 80, T) overrides the random init (parity tests hand it the JAX
    noise).  Returns mel (B, 80, T)."""
    b, t, _ = mu.shape
    n_mels = prompt.shape[1]
    if noise is None:
        noise = torch.randn((b, n_mels, t), generator=generator,
                            device=mu.device, dtype=torch.float32)
    z = noise * temperature
    frame = torch.arange(t, device=mu.device)
    prompt_mask = (frame[None, :] < prompt_len[:, None])[:, None, :]
    x = torch.where(prompt_mask, 0.0, z)
    t_span = torch.linspace(0.0, 1.0, n_steps + 1, device=mu.device)
    if cfg_rate > 0:
        p2 = torch.cat([prompt, torch.zeros_like(prompt)], dim=0)
        s2 = torch.cat([style, torch.zeros_like(style)], dim=0)
        m2 = torch.cat([mu, torch.zeros_like(mu)], dim=0)
        l2 = torch.cat([x_len, x_len], dim=0)
    for i in range(n_steps):
        t_cur = t_span[i]
        dt = t_span[i + 1] - t_span[i]
        tab = tables(i) if tables is not None else None
        if cfg_rate > 0:
            x2 = torch.cat([x, x], dim=0)
            v2 = velocity(x2, p2, l2, t_cur.expand(2 * b), s2, m2, tab)
            v, v_null = torch.chunk(v2, 2, dim=0)
            v = (1.0 + cfg_rate) * v - cfg_rate * v_null
        else:
            v = velocity(x, prompt, x_len, t_cur.expand(b), style, mu, tab)
        x = x + dt * v
        x = torch.where(prompt_mask, 0.0, x)
    return x
