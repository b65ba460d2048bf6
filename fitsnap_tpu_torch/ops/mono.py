"""Monomial-basis formulation of the Wigner-U expansion (host-side plan).

Every element of the SNAP hyperspherical expansion u^j_{mb,ma} is a
homogeneous polynomial of degree j in the four Cayley-Klein reals
(ar, ai, br, bi).  The LAMMPS-style two-term recursion
(`fitsnap_tpu_torch/ops/snap.py:compute_ulist`, mirroring `compute_uarray` in the
reference's embedded LAMMPS ML-SNAP package) is therefore equivalent to:

    U_flat (2*u_len reals)  =  L  @  M(ar, ai, br, bi)

where M is the vector of ALL monomials of degree <= twojmax (one fused
elementwise product chain — a DAG where each monomial is one multiply of a
previous monomial by one variable) and L is a constant change-of-basis
matrix computed here EXACTLY by propagating polynomials through the same
recursion.

Why: on TPU the triangular per-j recursion materializes dozens of small
padded/flipped/masked tensors per pair (HBM-traffic bound, ~20x off
speed-of-light); the monomial form is a pure elementwise chain (fuses into
registers) plus one MXU-shaped GEMM, and carries forward-mode tangents for
the cost of 3 extra chains sharing the same GEMM.
"""

from functools import lru_cache

import numpy as np


class _Poly:
    """Real-coefficient polynomial over monomials in 4 variables.

    Monomials keyed by exponent tuples (p, q, r, s) for (ar, ai, br, bi).
    """

    __slots__ = ("c",)

    def __init__(self, c=None):
        self.c = dict(c or {})

    @staticmethod
    def const(v):
        return _Poly({(0, 0, 0, 0): float(v)} if v else {})

    @staticmethod
    def var(i):
        e = [0, 0, 0, 0]
        e[i] = 1
        return _Poly({tuple(e): 1.0})

    def __add__(self, o):
        if isinstance(o, (int, float)):
            o = _Poly.const(o)
        c = dict(self.c)
        for k, v in o.c.items():
            c[k] = c.get(k, 0.0) + v
        return _Poly(c)

    __radd__ = __add__

    def __sub__(self, o):
        return self + (-1.0) * o

    def __rsub__(self, o):
        return (-1.0) * self + o

    def __neg__(self):
        return (-1.0) * self

    def __mul__(self, o):
        if isinstance(o, (int, float, np.floating)):
            return _Poly({k: v * float(o) for k, v in self.c.items()})
        c = {}
        for k1, v1 in self.c.items():
            for k2, v2 in o.c.items():
                k = tuple(a + b for a, b in zip(k1, k2))
                c[k] = c.get(k, 0.0) + v1 * v2
        return _Poly(c)

    __rmul__ = __mul__


def monomial_dag(degmax: int):
    """All monomials of degree <= degmax over 4 vars, as a product DAG.

    Returns (exponents (n, 4) int array, parent (n,) int, var (n,) int):
    monomial[i] = monomial[parent[i]] * variable[var[i]] for i >= 1;
    monomial[0] = 1.  Ordered by total degree, then lex.
    """
    exps = [(0, 0, 0, 0)]
    index = {(0, 0, 0, 0): 0}
    parent, var = [-1], [-1]
    for d in range(1, degmax + 1):
        for p in range(d, -1, -1):
            for q in range(d - p, -1, -1):
                for r in range(d - p - q, -1, -1):
                    s = d - p - q - r
                    e = (p, q, r, s)
                    for vi, red in enumerate(
                            [(p - 1, q, r, s), (p, q - 1, r, s),
                             (p, q, r - 1, s), (p, q, r, s - 1)]):
                        if min(red) >= 0:
                            index[e] = len(exps)
                            exps.append(e)
                            parent.append(index[red])
                            var.append(vi)
                            break
    return (np.array(exps, np.int64), np.array(parent, np.int64),
            np.array(var, np.int64))


def _ulist_polys(twojmax: int):
    """Run the U recursion over polynomial entries (exact; host-side)."""
    from fitsnap_tpu_torch.ops.cg import rootpq_tables, sym_signs

    tables = rootpq_tables(twojmax)
    signs = sym_signs(twojmax)
    ar, ai = _Poly.var(0), _Poly.var(1)
    br, bi = _Poly.var(2), _Poly.var(3)
    zero = _Poly.const(0.0)

    def grid(n):
        return np.full((n, n), zero, object)

    u = [(np.full((1, 1), _Poly.const(1.0), object), grid(1))]
    for j in range(1, twojmax + 1):
        pr, pi = u[j - 1]
        pr_a, pi_a = grid(j + 1), grid(j + 1)
        pr_b, pi_b = grid(j + 1), grid(j + 1)
        pr_a[:j, :j] = pr
        pi_a[:j, :j] = pi
        pr_b[:j, 1:] = pr
        pi_b[:j, 1:] = pi
        ca, cb = tables[j - 1]
        half_r, half_i = grid(j + 1), grid(j + 1)
        for mb in range(j + 1):
            for ma in range(j + 1):
                ta_r = ar * pr_a[mb, ma] + ai * pi_a[mb, ma]
                ta_i = ar * pi_a[mb, ma] - ai * pr_a[mb, ma]
                tb_r = br * pr_b[mb, ma] + bi * pi_b[mb, ma]
                tb_i = br * pi_b[mb, ma] - bi * pr_b[mb, ma]
                half_r[mb, ma] = ca[mb, ma] * ta_r - cb[mb, ma] * tb_r
                half_i[mb, ma] = ca[mb, ma] * ta_i - cb[mb, ma] * tb_i
        sign = signs[j - 1]
        ur, ui = grid(j + 1), grid(j + 1)
        for mb in range(j + 1):
            for ma in range(j + 1):
                if 2 * mb <= j:
                    ur[mb, ma] = half_r[mb, ma]
                    ui[mb, ma] = half_i[mb, ma]
                else:
                    ur[mb, ma] = sign[mb, ma] * half_r[j - mb, j - ma]
                    ui[mb, ma] = -sign[mb, ma] * half_i[j - mb, j - ma]
        u.append((ur, ui))
    return u


@lru_cache(maxsize=None)
def mono_plan(twojmax: int):
    """(exponents, parent, var, L) with L (n_mono, 2*u_len) mapping the
    monomial vector to flattened [ur | ui] (the `flatten_ulist` layout)."""
    exps, parent, var = monomial_dag(twojmax)
    index = {tuple(e): i for i, e in enumerate(exps)}
    u = _ulist_polys(twojmax)
    cols = []
    for comp in (0, 1):
        for j in range(twojmax + 1):
            grid_ = u[j][comp]
            for mb in range(j + 1):
                for ma in range(j + 1):
                    cols.append(grid_[mb, ma])
    L = np.zeros((len(exps), len(cols)))
    for ci, poly in enumerate(cols):
        for e, v in poly.c.items():
            L[index[e], ci] = v
    return exps, parent, var, L


@lru_cache(maxsize=None)
def grid_plan(twojmax: int):
    """Pair-grid factorization of the monomial basis.

    Every monomial ar^p ai^q br^r bi^s factors as T1[(p,q)] * T2[(r,s)]
    with T1/T2 indexed by the n_t = (tj+1)(tj+2)/2 exponent pairs of
    degree <= twojmax.  Returns (pidx, qidx, Lg):
      pidx, qidx: (n_t,) int — T-entry (p, q) exponents (same table for T2)
      Lg: (n_t, n_t, 2*u_len) — change-of-basis tensor on the grid,
          Lg[i1, i2] = L[mono(p,q,r,s)] (zero where total degree > twojmax)

    Why: the product-DAG chain (`mono_plan`) emits one tiny fused op per
    monomial — ~500 kernel launches per training step on TPU, measured
    launch-bound at <10% of HBM peak.  On the grid the whole basis is two
    45-entry power-product tensors and batched GEMMs.
    """
    exps, parent, var, L = mono_plan(twojmax)
    pairs = [(p, q) for p in range(twojmax + 1)
             for q in range(twojmax + 1 - p)]
    pair_index = {pq: i for i, pq in enumerate(pairs)}
    n_t = len(pairs)
    index = {tuple(e): i for i, e in enumerate(np.asarray(exps))}
    Lg = np.zeros((n_t, n_t, L.shape[1]))
    for (p, q), i1 in pair_index.items():
        for (r, s), i2 in pair_index.items():
            if p + q + r + s <= twojmax:
                Lg[i1, i2] = L[index[(p, q, r, s)]]
    pidx = np.array([p for p, q in pairs], np.int32)
    qidx = np.array([q for p, q in pairs], np.int32)
    return pidx, qidx, Lg


@lru_cache(maxsize=None)
def mono_pairs(twojmax: int):
    """(i1g, i2g): grid-pair index of every monomial, aligned with the
    `mono_plan` row order — monomial m = T1[i1g[m]] * T2[i2g[m]] with
    T1/T2 the `grid_plan` power-product tables."""
    exps, parent, var = monomial_dag(twojmax)
    pairs = [(p, q) for p in range(twojmax + 1)
             for q in range(twojmax + 1 - p)]
    pair_index = {pq: i for i, pq in enumerate(pairs)}
    i1g = np.array([pair_index[(p, q)] for p, q, r, s in exps], np.int32)
    i2g = np.array([pair_index[(r, s)] for p, q, r, s in exps], np.int32)
    return i1g, i2g


@lru_cache(maxsize=None)
def mono_blocks(twojmax: int):
    """Degree-block structure of the monomial->U map.

    Every U^j component is a homogeneous polynomial of degree 2j in the four
    Cayley-Klein reals, so L (mono_plan) is block-diagonal: monomials of
    degree d map ONLY to the U columns of j = d/2.  Contracting per block
    cuts the GEMM flops ~5x at twojmax 8 (the dense L is ~98% zeros).

    Returns (blocks, u_len) with blocks = tuple of (r0, r1, c0, c1): monomial
    row range [r0, r1) of degree 2j and real-column range [c0, c1) of that j
    (the imag columns are [u_len + c0, u_len + c1)).
    """
    exps, parent, var, L = mono_plan(twojmax)
    deg = np.asarray(exps).sum(1)
    assert (np.diff(deg) >= 0).all(), "monomials not degree-sorted"
    u_len = L.shape[1] // 2
    blocks = []
    c0 = 0
    for j in range(twojmax + 1):
        d = j  # degree == j index in the recursion (U^j is degree j in
        # the four reals: one factor of a/b per recursion level)
        rows = np.where(deg == d)[0]
        ncols = (j + 1) * (j + 1)
        r0, r1 = (int(rows[0]), int(rows[-1]) + 1) if len(rows) else (0, 0)
        blocks.append((r0, r1, c0, c0 + ncols))
        c0 += ncols
    assert c0 == u_len, (c0, u_len)
    return tuple(blocks), u_len
