"""K-nearest-neighbour primitives: the `distCUDA2` scale prior
(`mean_knn_sqdist`) and the rigidity loss's `knn` / `knn_gather`. Port of
`rodygs_tpu/ops/knn.py`.

On a CUDA tensor `knn` is one launch of `csrc/knn.cu`, which keeps each
query's k best in registers and writes no distance block. The plain
version (`knn_plain`, every CPU tensor) is blocked over query rows so the
N x M distance matrix is never held whole: each block is one [B, M]
product through the dot-product identity ||a-b||^2 = ||a||^2 + ||b||^2 -
2 a.b (as the JAX package computes it), followed by `topk`. The JAX
package scans blocks of targets with a running k-best set instead; all
three give the k smallest, in ascending order.
"""

from __future__ import annotations

import torch

from .. import kernels

# the k that csrc/knn.cu is instantiated for: the rigidity loss's 8 and the
# scale prior's 3 + 1
KERNEL_KS = (4, 8)


def _block_sqdist(query: torch.Tensor, targets: torch.Tensor,
                  tn: torch.Tensor) -> torch.Tensor:
    """[B,3] x [M,3] -> squared distances [B,M]; `tn` = |targets|^2 (+inf
    for a target no query may take). One product with the norms as its
    addend, clamped in place: three passes over the [B, M] block."""
    qn = torch.sum(query * query, dim=1, keepdim=True)
    return torch.addmm(qn + tn[None, :], query, targets.T,
                       alpha=-2.0).clamp_(min=0.0)


def knn(query: torch.Tensor, targets: torch.Tensor, k: int,
        valid_mask: torch.Tensor | None = None, block_size: int = 4096):
    """K nearest targets of each query point.

    query [N, 3], targets [M, 3]; invalid targets (`valid_mask` [M] False)
    get +inf distance. Returns (squared distances [N, k], indices [N, k]
    int32), ascending; a slot no valid target fills has distance +inf and
    index -1. On a CUDA tensor, one kernel launch (`knn_cuda`, which raises
    for a k outside KERNEL_KS), which puts the lower target index first
    among equal distances; on the CPU the plain version (`block_size` is
    its). Ties between equal distances may order differently from the JAX
    package's scan."""
    if query.is_cuda:
        return knn_cuda(query, targets, k, valid_mask)
    return knn_plain(query, targets, k, valid_mask, block_size)


def knn_cuda(query: torch.Tensor, targets: torch.Tensor, k: int,
             valid_mask: torch.Tensor | None = None):
    """`knn` as one launch of csrc/knn.cu. Raises on what the kernel does
    not take: tensors off the card, other than float32 [N, 3] / [M, 3]
    (bool [M] mask), not contiguous, or k outside KERNEL_KS."""
    if query.ndim != 2 or query.shape[1] != 3:
        raise ValueError(f"knn query: expected [N, 3], got {tuple(query.shape)}")
    if targets.ndim != 2 or targets.shape[1] != 3:
        raise ValueError(
            f"knn targets: expected [M, 3], got {tuple(targets.shape)}")
    m = targets.shape[0]
    if valid_mask is not None and tuple(valid_mask.shape) != (m,):
        raise ValueError(f"knn valid_mask: expected [{m}], got "
                         f"{tuple(valid_mask.shape)}")
    if k not in KERNEL_KS:
        raise ValueError(f"knn: the kernel takes k in {KERNEL_KS}, not {k}")
    kernels.check_cuda(query, "knn query", torch.float32, 2)
    kernels.check_cuda(targets, "knn targets", torch.float32, 2)
    if valid_mask is not None:
        kernels.check_cuda(valid_mask, "knn valid_mask", torch.bool, 1)
    if any(t.device != query.device for t in (targets, valid_mask)
           if t is not None):
        raise ValueError("knn: query, targets and valid_mask on one card")
    n = query.shape[0]
    best_d = torch.empty((n, k), dtype=torch.float32, device=query.device)
    best_i = torch.empty((n, k), dtype=torch.int32, device=query.device)
    if n:
        _launch(query, targets, valid_mask, k, best_d, best_i)
    return best_d, best_i


@torch.library.custom_op(
    "rodygs::knn", mutates_args=("best_d", "best_i"),
    schema="(Tensor query, Tensor targets, Tensor? valid_mask, int k, "
           "Tensor(a!) best_d, Tensor(b!) best_i) -> ()")
def _launch(query, targets, valid_mask, k, best_d, best_i) -> None:
    """One launch of csrc/knn.cu as an operator of PyTorch's dispatcher.
    The profiler links a kernel to the operator that launched it, and so
    to the spans around it (`rigidity_knn`); a launch from plain Python
    would belong to none of them."""
    kernels.launch("knn", query, query.shape[0], targets, targets.shape[0],
                   valid_mask, k, best_d, best_i)


def knn_plain(query: torch.Tensor, targets: torch.Tensor, k: int,
              valid_mask: torch.Tensor | None = None, block_size: int = 4096):
    """`knn` by blocks of `block_size` query rows, each a [B, M] product and
    a `topk`: the kernel's plain version."""
    n = query.shape[0]
    tn = torch.sum(targets * targets, dim=1)
    if valid_mask is not None:
        tn = torch.where(valid_mask, tn, torch.inf)
    best_d = torch.empty((n, k), dtype=query.dtype, device=query.device)
    best_i = torch.empty((n, k), dtype=torch.int32, device=query.device)
    for s in range(0, n, block_size):
        d = _block_sqdist(query[s:s + block_size], targets, tn)
        if d.shape[1] < k:
            d = torch.nn.functional.pad(d, (0, k - d.shape[1]), value=torch.inf)
        vals, idx = torch.topk(d, k, dim=1, largest=False, sorted=True)
        best_d[s:s + block_size] = vals
        best_i[s:s + block_size] = torch.where(
            torch.isinf(vals), -1, idx).to(torch.int32)
    return best_d, best_i


def knn_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather [M, D...] features at [N, K] indices -> [N, K, D...]. An index
    of -1 reads the last row, as the JAX gather does."""
    return x[idx.long()]


def mean_knn_sqdist(points: torch.Tensor, k: int = 3,
                    valid_mask: torch.Tensor | None = None,
                    block_size: int = 2048) -> torch.Tensor:
    """Mean squared distance of each point to its k nearest OTHER points
    (exact; the nearest hit, the self-match, is dropped)."""
    d, _ = knn(points, points, k + 1, valid_mask=valid_mask,
               block_size=block_size)
    return torch.mean(d[:, 1:], dim=1)
