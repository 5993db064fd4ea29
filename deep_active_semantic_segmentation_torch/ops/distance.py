"""Greedy geometric selection: k-center greedy and max-coverage (own copy
of the JAX package's ops/distance.py).

Parity targets:
* k-center greedy — reference active_selection/core_set.py:17-38: min
  distance to the already-labeled set, then argmax / update per center;
* max-representative greedy — reference active_selection/max_subset.py
  :17-39: each step picks the candidate that minimizes the summed min
  distance from every pool point to the picked set.

Both loops run on the features' device with no wait on the host per pick:
the index stays a 0-d device tensor, rows and columns are taken with
``index_select`` and picks are written into a preallocated device tensor.
Ties go to the first occurrence (``argmax`` / ``argmin``), and chosen
candidates are masked with ``inf``, as in the JAX package. Distances are
f32; the matmuls must run at full f32 precision (PyTorch's default; the
selectors call these under TF32 off).
"""

from __future__ import annotations

import torch


def pairwise_euclidean(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, D) x (M, D) -> (N, M) f32 euclidean distances."""
    a, b = a.float(), b.float()
    sq = ((a * a).sum(dim=1)[:, None] + (b * b).sum(dim=1)[None, :]
          - 2.0 * a @ b.T)
    return sq.clamp_min_(0.0).sqrt_()


def kcenter_greedy(features: torch.Tensor, seed_mask: torch.Tensor,
                   selection_size: int) -> torch.Tensor:
    """(selection_size,) int64 indices into ``features`` (N, D), in pick
    order; ``seed_mask`` (N,) bool marks the already-selected points. With
    no seed every distance is inf and the first pick is index 0."""
    features = features.float()
    seed_mask = seed_mask.to(device=features.device, dtype=torch.bool)
    sq_norms = (features * features).sum(dim=1)
    inf = torch.tensor(float("inf"), device=features.device)
    min_d = torch.where(seed_mask[None, :],
                        pairwise_euclidean(features, features), inf).amin(dim=1)
    min_d = torch.where(seed_mask, torch.zeros_like(min_d), min_d)
    picked = torch.empty(selection_size, dtype=torch.int64,
                         device=features.device)
    for k in range(selection_size):
        ind = min_d.argmax().view(1)
        center = features.index_select(0, ind)                      # (1, D)
        d2 = (sq_norms + sq_norms.index_select(0, ind)
              - 2.0 * (features @ center.T).view(-1))
        min_d = torch.minimum(min_d, d2.clamp_min_(0.0).sqrt_())
        picked[k:k + 1] = ind
    return picked


def max_representative(all_features: torch.Tensor,
                       candidate_features: torch.Tensor,
                       selection_count: int) -> torch.Tensor:
    """(selection_count,) int64 candidate indices in pick order: the
    greedy max-coverage subset of ``candidate_features`` (K, D) over the
    pool ``all_features`` (M, D). One (M, K) buffer serves every step."""
    dists = pairwise_euclidean(all_features, candidate_features)   # (M, K)
    m, k = dists.shape
    device = dists.device
    min_d = torch.full((m,), float("inf"), device=device)
    chosen = torch.zeros(k, dtype=torch.bool, device=device)
    picked = torch.empty(selection_count, dtype=torch.int64, device=device)
    tmp = torch.empty_like(dists)
    for step in range(selection_count):
        torch.minimum(min_d[:, None], dists, out=tmp)
        scores = tmp.sum(dim=0).masked_fill_(chosen, float("inf"))
        best = scores.argmin().view(1)
        min_d = tmp.index_select(1, best).view(-1)
        chosen.index_fill_(0, best, True)
        picked[step:step + 1] = best
    return picked
