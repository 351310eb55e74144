"""Training losses with the reference's MultiLoss semantics. Port of
`rodygs_tpu/train/losses.py`: every registered term (SSIM, L1, global and
local Pearson depth, motion L1, motion sparsity, rigidity, motion-basis
regularisation) and `MultiLoss.from_config`.

`freq` / `start` gating is decided on the host per iteration
(`active_set`), as in the JAX package. Randomness comes from the
`torch.Generator` in `ctx["rng"]`, drawn only in `box_origins`,
`rigidity_permutation` and `rigidity_times`. Images are channels-last
[H, W, C].
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..ops.image import (charbonnier_loss, l1_loss, pearson_depth_loss,
                         pearson_rows, ssim)
from ..ops.knn import knn, knn_gather
from ..ops.quaternion import quat_to_matrix
from ..utils.profiling import host_read, span


def _safe_norm(x, dim=-1, eps=1e-12):
    """L2 norm with the JAX package's finite gradient at x = 0 (KNN
    self-pairs make exact zero difference vectors routine here)."""
    return torch.sqrt(torch.sum(x * x, dim=dim) + eps)


def _masked_pair(pred, gt, motion_mask, mode):
    """The reference's static/dynamic mask-multiply semantics."""
    if motion_mask is None or mode in (None, "all"):
        return pred, gt
    m = motion_mask.to(pred.dtype)
    if mode == "static":
        m = 1.0 - m
    if m.ndim == pred.ndim - 1:
        m = m[..., None]
    return pred * m, gt * m


def ssim_loss(ctx, mode=None, **_):
    p, g = _masked_pair(ctx["pred_img"], ctx["gt_img"], ctx.get("motion_mask"), mode)
    return 1.0 - ssim(p, g)


def l1_loss_fn(ctx, mode=None, **_):
    p, g = _masked_pair(ctx["pred_img"], ctx["gt_img"], ctx.get("motion_mask"), mode)
    return l1_loss(p, g)


def global_pearson_depth(ctx, mode=None, eps=1e-6, **_):
    mask = None
    mm = ctx.get("motion_mask")
    if mm is not None and mode in ("static", "dynamic"):
        mask = (1.0 - mm) if mode == "static" else mm
    return pearson_depth_loss(ctx["pred_depth"], ctx["gt_depth"], eps, mask)


def box_origins(generator: torch.Generator, n: int, h: int, w: int,
                box_p: int, device):
    """Top-left corners (rows, columns) of the local Pearson boxes."""
    return (torch.randint(0, max(h - box_p, 1), (n,), generator=generator,
                          device=device),
            torch.randint(0, max(w - box_p, 1), (n,), generator=generator,
                          device=device))


def local_pearson_depth(ctx, box_p: int, p_corr: float, mode=None, eps=1e-6,
                        **_):
    """Pearson depth loss over p_corr of the box_p x box_p boxes a frame
    holds, at random corners, averaged (`LocalPearsonDepthLoss`)."""
    pred, gt = ctx["pred_depth"], ctx["gt_depth"]
    h, w = pred.shape
    n_corr = int(p_corr * (h // box_p) * (w // box_p))
    if n_corr == 0:
        return torch.zeros((), device=pred.device)
    x0, y0 = box_origins(ctx["rng"], n_corr, h, w, box_p, pred.device)
    span = torch.arange(box_p, device=pred.device)
    rows = (x0[:, None] + span)[:, :, None]
    cols = (y0[:, None] + span)[:, None, :]
    pb = pred[rows, cols].reshape(n_corr, -1)
    gb = gt[rows, cols].reshape(n_corr, -1)
    return torch.sum(pearson_rows(pb, gb, eps)) / n_corr


def motion_l1(ctx, **_):
    """mean |motion_coeff| over alive Gaussians (`MotionL1Loss`)."""
    coeff = ctx["motion_coeff"]  # [C, 1, B]
    alive = ctx["alive"].to(coeff.dtype)
    denom = torch.clamp(torch.sum(alive), min=1.0) * coeff.shape[1] * coeff.shape[2]
    return torch.sum(torch.abs(coeff) * alive[:, None, None]) / denom


def motion_sparsity(ctx, **_):
    """max-normalised |coeff| mean (`MotionSparsityLoss`)."""
    coeff = ctx["motion_coeff"]
    alive = ctx["alive"].to(coeff.dtype)
    a = torch.abs(coeff)
    mx = torch.amax(a, dim=2, keepdim=True)
    normalized = a / (mx + 1e-7)
    denom = torch.clamp(torch.sum(alive), min=1.0) * coeff.shape[1] * coeff.shape[2]
    return torch.sum(normalized * alive[:, None, None]) / denom


def rigidity_permutation(generator: torch.Generator, c: int, device):
    """The random order the rigidity sample is drawn in."""
    return torch.randperm(c, generator=generator, device=device)


def rigidity_times(generator: torch.Generator, n: int, num_t: int, device):
    """The motion-table rows the distance-preserving term compares."""
    return torch.randint(0, max(num_t - 1, 1), (n,), generator=generator,
                         device=device)


def rigidity(ctx, scale: float = 2.0, K: int = 8, sim_metric: str = "l2",
             dist_weight_lambda: float = 0.1, color_sim: bool = True,
             dist_preserving_ratio: int = 4, mode: Sequence[str] = ("coeff",),
             **_):
    """KNN rigidity regulariser (`RigidityLoss`) over a sample of C//scale
    slots, alive ones first; dead picks are masked out of every mean."""
    xyz = ctx["canon_xyz"]                 # [C, 3] canonical positions
    transl = ctx["pred_translation"]       # [C, 3] current deformation
    coeff = ctx["motion_coeff"][:, 0, :]   # [C, B]
    colors = ctx["features_dc"][:, 0, :]   # [C, 3]
    alive = ctx["alive"]
    dev = xyz.device
    c = xyz.shape[0]
    s = max(int(c / scale), K + 1)

    perm = rigidity_permutation(ctx["rng"], c, dev)
    # alive slots first: a stable sort pushes dead ones to the back
    order = torch.argsort(torch.where(alive[perm], 0, 1), stable=True)
    idx = perm[order][:s]
    valid = alive[idx]

    pts = xyz[idx] + transl[idx]
    # the KNN finds neighbour indices only, without gradient; the K squared
    # distances are recomputed from the gathered positions, differentiably
    with span("rigidity_knn", device=True):
        _, nn_idx = knn(pts.detach(), pts.detach(), k=K, valid_mask=valid)
    nn_pts = knn_gather(pts, nn_idx)  # [S, K, 3]
    dists = torch.sum((pts[:, None, :] - nn_pts) ** 2, dim=-1)  # [S, K]
    dists = torch.where(valid[:, None], dists, 0.0)
    vcount = torch.clamp(torch.sum(valid.to(torch.float32)), min=1.0)

    total = torch.zeros((), device=dev)

    if "surface" in mode:
        mean_nn = torch.mean(nn_pts, dim=1)
        d = _safe_norm(pts - mean_nn, dim=1)
        total = total + torch.sum(torch.where(valid, d, 0.0)) / vcount

    if "coeff" in mode:
        coeff_s = coeff[idx]
        coeff_nn = knn_gather(coeff_s, nn_idx)          # [S, K, B]
        color_s = colors[idx]
        color_nn = knn_gather(color_s, nn_idx)          # [S, K, 3]
        color_d = _safe_norm(color_s[:, None] - color_nn)
        dist_w = torch.exp(-dist_weight_lambda * dists**2)
        color_w = torch.exp(-dist_weight_lambda * color_d**2)
        if sim_metric == "l2":
            sim = _safe_norm(coeff_s[:, None] - coeff_nn)
        elif sim_metric == "l1":
            sim = torch.sum(torch.abs(coeff_s[:, None] - coeff_nn), dim=-1)
        else:  # cosine
            num = torch.sum(coeff_s[:, None] * coeff_nn, dim=-1)
            den = (torch.linalg.norm(coeff_s, dim=-1)[:, None]
                   * torch.linalg.norm(coeff_nn, dim=-1) + 1e-8)
            sim = num / den
        sim = (color_w * dist_w * sim) if color_sim else (dist_w * sim)
        total = total + torch.sum(torch.where(valid[:, None], sim, 0.0)) / (vcount * K)

    if "distance_preserving" in mode:
        table = ctx["motion_table"]  # [T, B, 7]
        num_t = table.shape[0]
        n_samp = max(num_t // dist_preserving_ratio, 1)
        tsel = rigidity_times(ctx["rng"], n_samp, num_t, dev)
        transl_basis = table[tsel][..., :3]  # [Ts, B, 3]
        coeff_s = coeff[idx]  # [S, B]
        transl_t = torch.einsum("sb,tbk->stk", coeff_s, transl_basis)
        nn_transl = knn_gather(transl_t, nn_idx)  # [S, K, Ts, 3]
        canon_s = xyz[idx]
        nn_canon = knn_gather(canon_s, nn_idx)    # [S, K, 3]
        loc_nn = nn_transl + nn_canon[:, :, None, :]
        loc_s = transl_t + canon_s[:, None, :]
        d_t = _safe_norm(loc_nn - loc_s[:, None, :, :])      # [S, K, Ts]
        valid_w = valid[:, None, None].to(torch.float32)
        # Charbonnier between the time-varying distances and the canonical
        # squared ones (the reference's comparison), out_norm "bc" over
        # [S*K, Ts, 1]
        x = (d_t * valid_w).reshape(-1, n_samp, 1)
        y = (dists[:, :, None] * valid_w).reshape(-1, 1, 1).expand(x.shape)
        total = total + charbonnier_loss(x, y, out_norm="bc")

    return total


# 16-entry frequency-weight banks (`MotionBasisRegularizaiton.coeff_bank`).
_COEFF_BANK = {
    "gaussian": [2.368737348178644, 2.3218332060968687, 2.186620166400238,
                 1.9785357455909518, 1.7200563444604107, 1.4367118264767467,
                 1.1529882480025957, 0.8890134170352768, 0.6585973377702478,
                 0.4687700396753248, 0.3205737399288996, 0.2106319563365025,
                 0.13296850925636292, 0.08064947764026723, 0.04699834214974086,
                 0.026314295000921823],
    "sigmoid": [0.0, 0.006057306357564347, 0.019407599012746118,
                0.04848852855754725, 0.11024831053568876, 0.23462085565239668,
                0.4602813915432914, 0.8016437593070956, 1.1983562406929047,
                1.539718608456709, 1.7653791443476032, 1.889751689464311,
                1.9515114714424528, 1.9805924009872535, 1.9939426936424351, 2.0],
    "laplacian": [3.0235547043507864, 2.475477220065594, 2.0267493286116927,
                  1.6593620041145454, 1.3585707032576908, 1.112303614987853,
                  0.910677176350366, 0.7455994104042655, 0.6104451667747834,
                  0.49979023110633275, 0.40919363229470634, 0.3350194107233597,
                  0.274290694437278, 0.22457022681891523, 0.18386255092234366,
                  0.15053392477948924],
    "cum_exponential": [0.24858106424723717, 0.45210202617930384,
                        0.6187308966091, 0.7551550771806206, 0.8668497492779882,
                        0.9582976122790642, 1.0331687900213073,
                        1.0944681257580495, 1.1446557770689725,
                        1.1857459506219796, 1.219387739359138,
                        1.246931306386802, 1.2694820717618154,
                        1.2879450768797849, 1.3030613069641026,
                        1.3154374294047362],
    "vanilla": [1.0] * 16,
}


def motion_basis_reg(ctx, transl_degree: int = 0, rot_degree: int = 0,
                     freq_div_mode: str = "vanilla",
                     apply_rot_matmul_derivative: bool = False, **_):
    """Velocity/acceleration smoothness of the motion basis over the motion
    table, frequency-weighted per basis (`MotionBasisRegularizaiton`).

    The reference's rotation "derivative" is elementwise matrix subtraction
    (its `is_rot` matmul branch is never reached); that is the default here
    too, and `apply_rot_matmul_derivative=True` opts into R[t+1] R[t]^T."""
    table = ctx["motion_table"]  # [T, B, 7]
    # degree-d derivatives need at least d+2 timesteps
    if table.shape[0] < max(transl_degree, rot_degree) + 2:
        return torch.zeros((), device=table.device)
    bank = np.asarray(_COEFF_BANK[freq_div_mode], np.float32)
    if freq_div_mode != "vanilla":
        bank = bank / bank.max() * 1.3
    with host_read():
        reg_coeff = torch.tensor(bank, device=table.device)[: table.shape[1]]

    transl = table[..., :3]  # [T, B, 3]
    rotq = table[..., 3:]
    t, b = rotq.shape[:2]
    # the basis rotations are tiny deltas around zero: eps 1e-8 keeps the
    # 2/|q|^2 backward finite, as in the JAX package
    rotm = quat_to_matrix(rotq.reshape(-1, 4), eps=1e-8).reshape(t, b, 3, 3)

    def deriv(x, degree):
        for _ in range(degree + 1):
            x = x[1:] - x[:-1]
        return x

    def rot_deriv_once(r):
        if apply_rot_matmul_derivative:
            return torch.einsum("tbij,tbkj->tbik", r[1:], r[:-1])
        return r[1:] - r[:-1]

    transl_d = deriv(transl, transl_degree)
    rot_d = rotm
    for _ in range(rot_degree + 1):
        rot_d = rot_deriv_once(rot_d)

    transl_norm = _safe_norm(transl_d) * reg_coeff[None]
    out = torch.mean(transl_norm) if transl_degree >= 0 else 0.0
    eye = torch.eye(3, device=table.device)
    rot_norm = _safe_norm(
        (eye[None, None] - rot_d).reshape(*rot_d.shape[:2], 9)) * reg_coeff[None]
    return out + (torch.mean(rot_norm) if rot_degree >= 0 else 0.0)


_LOSS_REGISTRY: dict[str, Callable] = {
    "SSIMLoss": ssim_loss,
    "L1Loss": l1_loss_fn,
    "GlobalPearsonDepthLoss": global_pearson_depth,
    "LocalPearsonDepthLoss": local_pearson_depth,
    "MotionL1Loss": motion_l1,
    "MotionSparsityLoss": motion_sparsity,
    "RigidityLoss": rigidity,
    "MotionBasisRegularizaiton": motion_basis_reg,   # (sic: reference name)
    "MotionBasisRegularization": motion_basis_reg,
}


@dataclasses.dataclass(frozen=True)
class LossTerm:
    name: str
    weight: float
    fn_name: str
    freq: int = 1
    start: int = 0
    params: tuple = ()  # tuple of (key, value) pairs

    def is_active(self, iteration: int) -> bool:
        return iteration % self.freq == 0 and iteration > self.start


class MultiLoss:
    """Weighted sum of sub-losses with freq/start gating."""

    def __init__(self, terms: Sequence[LossTerm]):
        for t in terms:
            if t.fn_name not in _LOSS_REGISTRY:
                raise NotImplementedError(
                    f"loss {t.fn_name!r} is not ported yet (registered: "
                    f"{sorted(_LOSS_REGISTRY)})")
        self.terms = tuple(terms)
        self._term_spans = tuple(f"loss.{t.name}" for t in self.terms)

    @classmethod
    def from_config(cls, loss_configs: Sequence[dict]) -> "MultiLoss":
        """Build from the reference's YAML list-of-dicts shape
        ({name, weight, freq, start, target, params})."""
        terms = []
        for cfg in loss_configs:
            target = cfg["target"].rsplit(".", 1)[-1]
            params = tuple(sorted(
                (k, tuple(v) if isinstance(v, (list, tuple)) else v)
                for k, v in dict(cfg.get("params") or {}).items()))
            terms.append(LossTerm(
                name=cfg["name"], weight=float(cfg["weight"]),
                fn_name=target, freq=int(cfg.get("freq", 1)),
                start=int(cfg.get("start", 0)), params=params))
        return cls(terms)

    def active_set(self, iteration: int) -> tuple[bool, ...]:
        return tuple(t.is_active(iteration) for t in self.terms)

    @property
    def uses_normal(self) -> bool:
        """Whether any term reads ctx["pred_normal"]; no registered one does."""
        normal_losses: set[str] = set()
        return any(t.fn_name in normal_losses for t in self.terms)

    def __call__(self, ctx: dict[str, Any], active: tuple[bool, ...]):
        device = ctx["pred_img"].device
        if ctx.get("rng") is None:
            ctx = {**ctx, "rng": torch.Generator(device=device).manual_seed(0)}
        with span("loss"):
            total = torch.zeros((), device=device)
            loss_dict = {}
            for term, on, name in zip(self.terms, active, self._term_spans):
                if not on:
                    continue
                with span(name):
                    val = _LOSS_REGISTRY[term.fn_name](ctx,
                                                       **dict(term.params))
                loss_dict[term.name] = val
                total = total + term.weight * val
        return total, loss_dict
