"""Padded periodic neighbor lists, built on the host with numpy.

Counterpart of the host side of `fitsnap_tpu/ops/neighbors.py`.  Cells follow
the reference's normalization: lattice vectors are the COLUMNS of an
upper-triangular 3x3 matrix, positions are row vectors wrapped into the cell.

Besides the (A, K) neighbor list this module builds its reverse table: for
every atom, the flat (i, k) slots whose neighbor it is.  The row-scatter
kernel (K4) gathers through it instead of scattering with atomics, so its
sums are deterministic.
"""

import numpy as np


def required_shifts(cell: np.ndarray, cutoff: float) -> np.ndarray:
    """Integer image ranges (n1, n2, n3) needed to cover `cutoff`.

    cell: (3,3) with lattice vectors as columns. Returns (3,) ints.
    """
    cell = np.asarray(cell, dtype=np.float64)
    # perpendicular distance between periodic planes i: 1/|row_i of cell^-1|
    inv = np.linalg.inv(cell)
    widths = 1.0 / np.linalg.norm(inv, axis=1)
    return np.ceil(cutoff / widths - 1e-12).astype(np.int64)


def shift_table(nmax: np.ndarray) -> np.ndarray:
    """All integer shifts within per-axis bounds, (S, 3), (0,0,0) first."""
    r1 = np.arange(-nmax[0], nmax[0] + 1)
    r2 = np.arange(-nmax[1], nmax[1] + 1)
    r3 = np.arange(-nmax[2], nmax[2] + 1)
    grid = np.stack(np.meshgrid(r1, r2, r3, indexing="ij"), -1).reshape(-1, 3)
    # put the home cell first so the self-pair exclusion is cheap
    order = np.argsort((grid != 0).any(1), kind="stable")
    return grid[order].astype(np.int64)


def _candidate_d2(pos, cell, natoms, cutoff):
    """(i, s, j) displacements pos[j] + svec[s] - pos[i] and their squares,
    with the home-cell self pair set to infinity."""
    pos = np.asarray(pos, np.float64)[:natoms]
    cell = np.asarray(cell, np.float64)
    shifts = shift_table(required_shifts(cell, cutoff))
    svec = shifts @ cell.T                                   # (S, 3)
    d = pos[None, None, :, :] + svec[None, :, None, :] - pos[:, None, None, :]
    d2 = np.einsum("isjc,isjc->isj", d, d)
    d2[:, 0, :][np.eye(natoms, dtype=bool)] = np.inf        # self in home cell
    return d, d2


def host_neighbors(pos, cell, natoms, cutoff, a_pad=None, k_pad=None):
    """Padded neighbor list for one config.

    Returns (disp (A,K,3), jidx (A,K), mask (A,K), count) with A/K padded if
    given; slots are ordered by image, then neighbor atom, as in the JAX
    package's numpy neighbor lists.
    """
    d, d2 = _candidate_d2(pos, cell, natoms, cutoff)
    hit = d2 < cutoff * cutoff                            # (A, S, A)
    counts = hit.sum(axis=(1, 2))
    kmax = int(counts.max()) if natoms else 0
    A = a_pad or natoms
    K = k_pad or kmax
    disp = np.zeros((A, K, 3))
    jidx = np.zeros((A, K), np.int32)
    mask = np.zeros((A, K), bool)
    ii, ss, jj = np.nonzero(hit)
    order = np.argsort(ii, kind="stable")
    ii, ss, jj = ii[order], ss[order], jj[order]
    slot = np.concatenate([np.arange(c) for c in counts]) if len(ii) else \
        np.zeros(0, int)
    disp[ii, slot] = d[ii, ss, jj]
    jidx[ii, slot] = jj
    mask[ii, slot] = True
    return disp, jidx, mask, kmax


def count_neighbors(pos, cell, natoms, cutoff) -> int:
    """Max neighbor count for one config."""
    _, d2 = _candidate_d2(pos, cell, natoms, cutoff)
    counts = (d2 < cutoff * cutoff).sum(axis=(1, 2))
    return int(counts.max()) if natoms else 0


def reverse_neighbors(jidx, mask, natoms):
    """Reverse neighbor table of one config.

    jidx, mask: (A, K) neighbor list.  Returns rev (natoms, R) int32: row n
    lists the flat slots i*K + k with mask[i, k] and jidx[i, k] == n, in
    increasing slot order, padded with -1; R is the largest in-degree.  An
    atom that is its own neighbor through periodic images appears once per
    such slot.
    """
    jidx = np.asarray(jidx)
    mask = np.asarray(mask, bool)
    K = mask.shape[1]
    ii, kk = np.nonzero(mask[:natoms])
    dest = jidx[ii, kk].astype(np.int64)
    order = np.argsort(dest, kind="stable")
    dest = dest[order]
    slots = (ii * K + kk)[order]
    counts = np.bincount(dest, minlength=natoms)
    R = int(counts.max()) if len(dest) else 0
    rev = np.full((natoms, R), -1, np.int32)
    col = np.arange(len(dest)) - np.repeat(np.cumsum(counts) - counts, counts)
    rev[dest, col] = slots
    return rev
