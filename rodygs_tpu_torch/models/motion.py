"""Low-rank motion model: a time-conditioned basis MLP and per-Gaussian
coefficients. Port of `rodygs_tpu/models/motion.py`.

sin/cos Fourier time embedding (include-input, linear or log-spaced
frequencies), a 3-layer timenet (width W, exact GELU) and B per-basis
2-layer heads producing (translation 3 + rotation quaternion 4) each; the B
heads are two batched weight tensors (`heads.w0 [B, W/2, W/4]`,
`heads.w1 [B, W/4, 7]`) evaluated with one einsum each. The parameters are
the JAX package's nested dict with the same names and layouts, so Adam
walks them as leaves and state converts one-to-one (convert.py).

With the shipped 26 linear frequencies (1 to 2^25), t*f*pi lies past 2^22
for most times, where float32 rounding of the argument alone decides the
feature. So the frequency table is built with the float32 operations XLA
emits for `jnp.linspace` (`xla_linspace`), bit for bit, and each argument
is rounded as XLA forms it (`embed_time`).
"""

from __future__ import annotations

import functools
import math
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.platform import resolve_device
from ..utils.profiling import host_read, span


class MotionNetConfig(NamedTuple):
    netwidth: int = 128
    num_basis: int = 16
    t_emb_multires: int = 26
    t_log_sampling: bool = False
    activation: str = "gelu"

    @property
    def t_embed_dim(self) -> int:
        return self.t_emb_multires * 2 + 1


def xla_linspace(start: float, stop: float, num: int) -> np.ndarray:
    """float32 `jnp.linspace(start, stop, num)` as XLA computes it, bit for
    bit. JAX writes start * (1 - step) + stop * step with step = iota / div
    and appends `stop`; XLA turns the division into a product with the
    float32 reciprocal and folds stop * (iota * r) into iota * (stop * r),
    each a float32 operation (read from the compiled HLO)."""
    f32 = np.float32
    if num == 1:
        return np.array([start], f32)
    r = f32(1) / f32(num - 1)
    c = f32(stop) * r
    i = np.arange(num - 1, dtype=f32)
    head = f32(start) * (f32(1) - i * r) + i * c
    return np.concatenate([head, np.array([stop], f32)]).astype(f32)


@functools.lru_cache(maxsize=None)
def _frequencies(multires: int, log_sampling: bool,
                 device: torch.device) -> torch.Tensor:
    """[multires] float32 frequencies, the JAX package's table; read only."""
    if log_sampling:
        freqs = np.float32(2.0) ** xla_linspace(0.0, multires - 1, multires)
    else:
        freqs = xla_linspace(1.0, 2.0 ** (multires - 1), multires)
    return torch.from_numpy(freqs.astype(np.float32)).to(device)


def embed_time(t, multires: int, log_sampling: bool) -> torch.Tensor:
    """[...]-shaped timesteps -> [..., 2*multires+1] Fourier features,
    ordered [t, sin(t f1), cos(t f1), sin(t f2), ...].

    The arguments are rounded as XLA forms them from the JAX package's
    `t[..., None] * (freqs * pi)`: t * (f * pi), except for a single time,
    whose broadcast XLA merges with pi's into f * (t * pi)."""
    t = torch.as_tensor(t, dtype=torch.float32)
    freqs = _frequencies(multires, log_sampling, t.device)
    with host_read():
        pi = torch.tensor(math.pi, dtype=torch.float32, device=t.device)
    if t.numel() == 1:
        tf = freqs * (t[..., None] * pi)
    else:
        tf = t[..., None] * (freqs * pi)
    sincos = torch.stack([torch.sin(tf), torch.cos(tf)], dim=-1).reshape(
        *t.shape, 2 * multires)
    return torch.cat([t[..., None], sincos], dim=-1)


def init_motion_params(generator: torch.Generator | int, cfg: MotionNetConfig,
                       device=None) -> dict[str, Any]:
    """Normal(0, 1e-2) weights, zero biases (the reference's init).
    `generator` is a torch.Generator on `device` or an int seed."""
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    w, b, d = cfg.netwidth, cfg.num_basis, cfg.t_embed_dim
    std = 1e-2

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev) * std

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    return {
        "timenet": {"w0": normal(d, w), "b0": zeros(w),
                    "w1": normal(w, w), "b1": zeros(w),
                    "w2": normal(w, w // 2), "b2": zeros(w // 2)},
        "heads": {"w0": normal(b, w // 2, w // 4), "b0": zeros(b, w // 4),
                  "w1": normal(b, w // 4, 7), "b1": zeros(b, 7)},
    }


def _act(cfg: MotionNetConfig):
    if cfg.activation.lower() == "relu":
        return F.relu
    return F.gelu   # exact (erf) GELU, the reference's nn.GELU()


@span("motion_mlp")
def basis_from_embedding(params: dict, cfg: MotionNetConfig,
                         t_emb: torch.Tensor) -> torch.Tensor:
    """[..., t_embed_dim] -> [..., B, 7] motion bases."""
    act = _act(cfg)
    tn = params["timenet"]
    h = act(t_emb @ tn["w0"] + tn["b0"])
    h = act(h @ tn["w1"] + tn["b1"])
    h = act(h @ tn["w2"] + tn["b2"])  # [..., W/2]
    hd = params["heads"]
    g = act(torch.einsum("...i,bij->...bj", h, hd["w0"]) + hd["b0"])
    return torch.einsum("...bj,bjk->...bk", g, hd["w1"]) + hd["b1"]


def motion_basis(params: dict, cfg: MotionNetConfig, t) -> torch.Tensor:
    """Scalar (or batched) time -> [B, 7] basis."""
    t = torch.as_tensor(t, dtype=torch.float32,
                        device=params["timenet"]["w0"].device)
    emb = embed_time(t, cfg.t_emb_multires, cfg.t_log_sampling)
    return basis_from_embedding(params, cfg, emb)


def apply_coefficients(motion_coeff: torch.Tensor, basis: torch.Tensor):
    """[N, 1, B] coeffs x [B, 7] basis -> (translation [N,3], rot-delta [N,4])."""
    tot = motion_coeff[:, 0, :] @ basis
    return tot[:, :3], tot[:, 3:]


def motion_table(params: dict, cfg: MotionNetConfig,
                 times: torch.Tensor) -> torch.Tensor:
    """[T] unique timesteps -> [T, B, 7] motion table."""
    return motion_basis(params, cfg, times)


def gaussian_deformation(
    params: dict,
    cfg: MotionNetConfig,
    motion_coeff: torch.Tensor,
    t,
    spatial_lr_scale: float,
    inverse_motion: bool = False,
    time_ind: torch.Tensor | None = None,
    times_table: torch.Tensor | None = None,
):
    """Per-Gaussian deformation at time `t`: the translation scaled by
    spatial_lr_scale; with `inverse_motion`, each Gaussian's birth-time
    motion is subtracted (canonicalisation)."""
    basis = motion_basis(params, cfg, t)  # [B, 7]
    translation, rotation = apply_coefficients(motion_coeff, basis)
    if inverse_motion:
        if time_ind is None or times_table is None:
            raise ValueError("inverse_motion needs time_ind and times_table")
        table = motion_table(params, cfg, times_table)  # [T, B, 7]
        # every (gaussian, birth time) pair, then each gaussian's own: the
        # backward of a row gather `table[time_ind]` accumulates repeated
        # indices one after another (all N gaussians on T rows), ~20 ms a
        # step on an H100 at N = 32,768 and T = 1; this one's is a matmul.
        # It holds N*T*7 floats.
        per_time = torch.einsum("nb,tbk->ntk", motion_coeff[:, 0, :], table)
        delta = torch.take_along_dim(
            per_time, time_ind.long()[:, None, None], dim=1)[:, 0]
        translation = translation - delta[:, :3]
        rotation = rotation - delta[:, 3:]
    return translation * spatial_lr_scale, rotation
