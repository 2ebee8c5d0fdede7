"""Brute-force Hamming 2-NN matching + Lowe ratio filtering, batched
over frames.

Counterpart of ``libstacker_tpu/ops/matcher.py`` (``unpack_descriptor_bits``
:32, ``hamming_distance_matrix`` :43, ``knn_match2`` :54,
``ratio_filter_sort_keep`` :91): ``BFMatcher(NORM_HAMMING)`` ``knnMatch``
with k=2 plus the reference's ratio / sort / keep-ratio filter
(ref src/lib.rs:208-242).

The distance matrix keeps the reference's identity
``popcount(a XOR b) = |a| + |b| - 2 a.b`` over unpacked {0,1} bits, as
one batched float32 matmul: every partial sum is an integer below 2^24,
so the product is exact on any device and in any summation order (and
in TF32 too, which ``utils/device.py`` turns off anyway), and on the
card it is one GEMM for the whole burst instead of 500x500 XOR-popcount
loops per frame.  Top-2 and the sort break ties by the lower index, as
``lax.top_k`` and the stable ``lexsort`` do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .fast import topk_stable

_BIG = 1e9


class KnnMatches(NamedTuple):
    train_idx: torch.Tensor  # [..., Q, 2] int64 — best / second-best
    distance: torch.Tensor  # [..., Q, 2] float32 — Hamming distances
    valid: torch.Tensor  # [..., Q] bool — both neighbours exist


def unpack_descriptor_bits(desc_u8: torch.Tensor) -> torch.Tensor:
    """``[..., K, 32]`` uint8 -> ``[..., K, 256]`` float32 {0,1} bits,
    LSB first within each byte."""
    shifts = torch.arange(8, device=desc_u8.device, dtype=torch.uint8)
    bits = (desc_u8[..., None] >> shifts) & 1
    return bits.reshape(*desc_u8.shape[:-1], -1).to(torch.float32)


def hamming_distance_matrix(
    query_bits: torch.Tensor, train_bits: torch.Tensor
) -> torch.Tensor:
    """``[..., Q, 256]`` x ``[..., T, 256]`` {0,1} -> ``[..., Q, T]``
    float32 Hamming distances."""
    q_pop = query_bits.sum(-1, keepdim=True)
    t_pop = train_bits.sum(-1, keepdim=True)
    dot = torch.matmul(query_bits, train_bits.transpose(-1, -2))
    return q_pop + t_pop.transpose(-1, -2) - 2.0 * dot


def knn_match2(
    query_desc: torch.Tensor,  # [Q, 32] uint8 (frame 0)
    train_desc: torch.Tensor,  # [N, T, 32] uint8
    query_valid: torch.Tensor,  # [Q] bool
    train_valid: torch.Tensor,  # [N, T] bool
) -> KnnMatches:
    """2-NN Hamming matching of one query set against each of N train
    sets.  Invalid train columns get distance 1e9; a query is valid when
    it is itself valid and its train set has at least two valid
    descriptors (ref src/lib.rs:221-230 requires m.len() == 2)."""
    qb = unpack_descriptor_bits(query_desc)
    tb = unpack_descriptor_bits(train_desc)
    dist = hamming_distance_matrix(qb, tb)  # [N, Q, T]
    dist = torch.where(train_valid[:, None, :], dist,
                       torch.full_like(dist, _BIG))
    neg_top, idx = topk_stable(-dist, 2)
    n_train = train_valid.sum(-1)
    valid = query_valid[None, :] & (n_train >= 2)[:, None]
    return KnnMatches(train_idx=idx, distance=-neg_top, valid=valid)


class FilteredMatches(NamedTuple):
    query_idx: torch.Tensor  # [..., Q] int64, sorted by distance
    train_idx: torch.Tensor  # [..., Q] int64
    distance: torch.Tensor  # [..., Q] float32
    keep: torch.Tensor  # [..., Q] bool — survives ratio test + keep cut
    count: torch.Tensor  # [...] int64 — number kept


def ratio_filter_sort_keep(
    matches: KnnMatches, match_ratio: float, match_keep_ratio: float,
) -> FilteredMatches:
    """Lowe ratio test, stable sort by distance, keep the best
    ``round(n * keep_ratio)`` (half away from zero, as Rust's ``round``;
    ref src/lib.rs:221-236)."""
    d0 = matches.distance[..., 0]
    d1 = matches.distance[..., 1]
    pass_ratio = matches.valid & (d0 < d1 * match_ratio)
    sort_key = torch.where(pass_ratio, d0, torch.full_like(d0, _BIG))
    d_sorted, order = torch.sort(sort_key, dim=-1, stable=True)
    n_pass = pass_ratio.sum(-1, keepdim=True).to(torch.float32)
    n_keep = torch.floor(
        n_pass * torch.tensor(match_keep_ratio, dtype=torch.float32) + 0.5)
    rank = torch.arange(d0.shape[-1], device=d0.device)
    keep = (rank < n_keep) & (d_sorted < _BIG)
    return FilteredMatches(
        query_idx=order,
        train_idx=torch.gather(matches.train_idx[..., 0], -1, order),
        distance=d_sorted,
        keep=keep,
        count=keep.sum(-1),
    )
