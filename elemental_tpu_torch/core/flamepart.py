"""FLAME-style partition helpers (counterpart of
``elemental_tpu/core/flamepart.py``; reference ``src/core/FlamePart``:
Partition/Repartition/SlidePartition — the blocked-algorithm bookkeeping).

Functional helpers over tensors: each returns views (slices), and
``merge_*`` reassembles.  They exist for algorithm authors porting
FLAME-style loops."""

from __future__ import annotations

import torch


def partition_down(A, m_top: int):
    """A → (A_T, A_B) with A_T holding ``m_top`` rows (``PartitionDown``)."""
    return A[:m_top], A[m_top:]


def partition_right(A, n_left: int):
    return A[:, :n_left], A[:, n_left:]


def partition_down_diagonal(A, k: int):
    """A → 2×2 quadrants split at diagonal index k (``PartitionDownDiagonal``)."""
    return (A[:k, :k], A[:k, k:],
            A[k:, :k], A[k:, k:])


def repartition_down(AT, AB, bsize: int):
    """(AT, AB) → (A0, A1, A2) exposing a ``bsize`` panel
    (``RepartitionDown``)."""
    return AT, AB[:bsize], AB[bsize:]


def repartition_right(AL, AR, bsize: int):
    return AL, AR[:, :bsize], AR[:, bsize:]


def repartition_down_diagonal(A, k: int, bsize: int):
    """3×3 blocks of A around the ``bsize`` diagonal panel at index k
    (``RepartitionDownDiagonal``): returns
    (A00, A01, A02, A10, A11, A12, A20, A21, A22)."""
    e = k + bsize
    return (A[:k, :k], A[:k, k:e], A[:k, e:],
            A[k:e, :k], A[k:e, k:e], A[k:e, e:],
            A[e:, :k], A[e:, k:e], A[e:, e:])


def slide_partition_down(A0, A1, A2):
    """Merge the processed panel back (``SlidePartitionDown``)."""
    return torch.cat([A0, A1], dim=0), A2


def slide_partition_right(A0, A1, A2):
    return torch.cat([A0, A1], dim=1), A2


def merge_2x2(A00, A01, A10, A11):
    top = torch.cat([A00, A01], dim=1)
    bot = torch.cat([A10, A11], dim=1)
    return torch.cat([top, bot], dim=0)
