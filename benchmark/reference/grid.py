"""Cell-list neighbour search in plain PyTorch: every ordered pair of
points closer than a radius. No code of the program."""

from __future__ import annotations

import itertools

import torch

OFFSETS = tuple(itertools.product((-1, 0, 1), repeat=3))


def _cells(pos: torch.Tensor, lo: torch.Tensor, cell: float):
    """Integer cell coordinates, shifted so that every stencil neighbour of
    an occupied cell has coordinates ≥ 0, and the strides of a key."""
    c = torch.floor((pos.float() - lo) / cell).long()
    c = c - c.min(0).values + 1
    dims = c.max(0).values + 2
    return c, (dims[1] * dims[2], dims[2])


def _key(c, strides):
    return c[:, 0] * strides[0] + c[:, 1] * strides[1] + c[:, 2]


def _table(keys: torch.Tensor):
    """(sorted order, distinct keys, first row of each, count of each)."""
    ks, order = torch.sort(keys)
    uniq, counts = torch.unique_consecutive(ks, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    return order, uniq, starts, counts


def _candidates(qc, strides, table, off):
    """For query cells `qc` moved by `off`: [Q, M] candidate data rows and
    their validity, M the fullest cell's count."""
    order, uniq, starts, counts = table
    want = _key(qc + torch.tensor(off, device=qc.device), strides)
    at = torch.searchsorted(uniq, want).clamp_max(len(uniq) - 1)
    n = torch.where(uniq[at] == want, counts[at], 0)
    m = int(counts.max())
    t = torch.arange(m, device=qc.device)
    ok = t[None, :] < n[:, None]
    rows = torch.where(ok, starts[at][:, None] + t[None, :], 0)
    return order[rows], ok


def pairs_within(pos: torch.Tensor, radius: float):
    """(i, j) int64 of every ordered pair i ≠ j with |pos_i − pos_j| <
    radius, by a cell list of edge `radius` and its 27-cell stencil."""
    lo = pos.float().min(0).values
    c, strides = _cells(pos, lo, radius)
    table = _table(_key(c, strides))
    r2 = radius * radius
    ii, jj = [], []
    idx = torch.arange(len(pos), device=pos.device)
    for off in OFFSETS:
        j, ok = _candidates(c, strides, table, off)
        d = pos[:, None, :] - pos[j]
        keep = ok & ((d * d).sum(-1).float() < r2) & (j != idx[:, None])
        i_k, t_k = torch.nonzero(keep, as_tuple=True)
        ii.append(i_k)
        jj.append(j[i_k, t_k])
    return torch.cat(ii), torch.cat(jj)
