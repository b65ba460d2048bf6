"""Host-side SNAP descriptor plan: Clebsch-Gordan tables and flattened index lists.

Everything here runs once at setup time (numpy, float64) and produces static
arrays that parameterize the jittable TPU kernels in `fitsnap_tpu_torch.ops.snap`.

Behavioral parity targets (conventions, not code):
  - b-list ordering and `blank2J`/chemflag/quadratic layout:
    reference `fitsnap3lib/io/sections/calculator_sections/bispectrum.py:69`
  - descriptor semantics of LAMMPS ML-SNAP `compute snap` as consumed by
    reference `fitsnap3lib/calculators/lammps_snap.py:391`.

The bispectrum is expressed as one flat trilinear contraction over the
neighbor-summed Wigner-U expansion `utot` (flattened to a vector of length
U = sum_j (j+1)^2 per element channel):

    B_t = sum_k coef[k] * Re( u[i1[k]] * u[i2[k]] * conj(u[i3[k]]) )

which maps onto gather + multiply + segment-sum — a layout XLA fuses well on
TPU (and later a Pallas kernel can consume the same plan).
"""

from dataclasses import dataclass, field
from math import factorial, sqrt

import numpy as np


def _fac(n: int) -> float:
    if n < 0:
        raise ValueError("negative factorial")
    return float(factorial(n))


def delta_cg(j1: int, j2: int, j: int) -> float:
    """Triangle coefficient (args are 2j integers)."""
    return sqrt(
        _fac((j1 + j2 - j) // 2)
        * _fac((j1 - j2 + j) // 2)
        * _fac((-j1 + j2 + j) // 2)
        / _fac((j1 + j2 + j) // 2 + 1)
    )


def cg_block(j1: int, j2: int, j: int) -> np.ndarray:
    """Clebsch-Gordan coefficients <j1 m1 j2 m2 | j (m1+m2)>.

    Args are 2j integers. Returns array of shape (j1+1, j2+1) indexed by
    (m1 index, m2 index) where m1 = m1_index - j1/2 in true units
    (i.e. 2*m1 = 2*m1_index - j1).  Entries where |m1+m2| > j/2 are zero.
    """
    out = np.zeros((j1 + 1, j2 + 1), dtype=np.float64)
    if (j1 + j2 - j) % 2 != 0:
        return out
    for m1i in range(j1 + 1):
        aa2 = 2 * m1i - j1
        for m2i in range(j2 + 1):
            bb2 = 2 * m2i - j2
            if (aa2 + bb2 + j) % 2 != 0:
                continue
            m = (aa2 + bb2 + j) // 2
            if m < 0 or m > j:
                continue
            zmin = max(0, max(-(j - j2 + aa2) // 2, -(j - j1 - bb2) // 2))
            zmax = min(
                (j1 + j2 - j) // 2,
                min((j1 - aa2) // 2, (j2 + bb2) // 2),
            )
            s = 0.0
            for z in range(zmin, zmax + 1):
                ifac = -1.0 if z % 2 else 1.0
                s += ifac / (
                    _fac(z)
                    * _fac((j1 + j2 - j) // 2 - z)
                    * _fac((j1 - aa2) // 2 - z)
                    * _fac((j2 + bb2) // 2 - z)
                    * _fac((j - j2 + aa2) // 2 + z)
                    * _fac((j - j1 - bb2) // 2 + z)
                )
            cc2 = 2 * m - j
            sfaccg = sqrt(
                _fac((j1 + aa2) // 2)
                * _fac((j1 - aa2) // 2)
                * _fac((j2 + bb2) // 2)
                * _fac((j2 - bb2) // 2)
                * _fac((j + cc2) // 2)
                * _fac((j - cc2) // 2)
                * (j + 1)
            )
            out[m1i, m2i] = s * delta_cg(j1, j2, j) * sfaccg
    return out


def b_triples(twojmax: int) -> list:
    """Ordered (j1, j2, j) descriptor triples (2j integers).

    Order matches the reference blist generation
    (`bispectrum.py:80-90`): j1 outer, j2 <= j1, j in |j1-j2|..min(2J,j1+j2)
    step 2, keeping only j >= j1.
    """
    triples = []
    for j1 in range(twojmax + 1):
        for j2 in range(j1 + 1):
            for j in range(j1 - j2, min(twojmax, j1 + j2) + 1, 2):
                if j >= j1:
                    triples.append((j1, j2, j))
    return triples


def u_layout(twojmax: int):
    """Flat layout of the (j, mb, ma) Wigner-U expansion.

    Returns (offsets per j, total length U). Entry (j, mb, ma) lives at
    offsets[j] + mb*(j+1) + ma, matching the row-major [mb, ma] blocks the
    kernel produces.
    """
    offsets = []
    tot = 0
    for j in range(twojmax + 1):
        offsets.append(tot)
        tot += (j + 1) * (j + 1)
    return offsets, tot


def _uidx(offsets, j, mb, ma):
    return offsets[j] + mb * (j + 1) + ma


@dataclass
class SnapPlan:
    """Static parameterization of the SNAP bispectrum kernel."""

    twojmax: int
    nelements: int
    chemflag: bool
    bnormflag: bool
    bzeroflag: bool
    wselfallflag: bool
    quadraticflag: bool

    # flat U layout
    u_offsets: list = field(default_factory=list)
    u_len: int = 0                       # per element channel

    # trilinear term arrays (see module docstring)
    i1: np.ndarray = None                # (nterms,) int32, includes elem-channel offset
    i2: np.ndarray = None
    i3: np.ndarray = None
    coef: np.ndarray = None              # (nterms,) float64
    tid: np.ndarray = None               # (nterms,) int32 output descriptor index
    mmat: np.ndarray = None              # (nterms_base, ntriples) dense coef matrix
    ntriples: int = 0
    nblocks: int = 1                     # nchem^3 element-triple blocks
    nb_base: int = 0                     # number of B columns before quadratic
    bzero: np.ndarray = None             # (nb_base,) float64, subtracted when bzeroflag

    # quadratic extension (indices into the base B vector)
    iq1: np.ndarray = None
    iq2: np.ndarray = None
    qcoef: np.ndarray = None             # 0.5 on diagonal terms, 1.0 otherwise

    # y-list plan (nchem==1): analytic dB/dutot via permuted z-lists
    # (LAMMPS compute_dbidrj identity). z-lists are evaluated per triple as
    # dense batched einsums against the CG tensor C[m, m1, m2] (MXU-shaped),
    # then dB/dutot rows are gathered from the flattened z values.
    z_dense: list = None                 # [(j1, j2, j, C (j+1, j1+1, j2+1))]
    y_src: np.ndarray = None             # (3, ntriples, U) int32 into nzflat
    y_fac: np.ndarray = None             # (3, ntriples, U) float64

    # self-contribution: utot diagonal indices (per channel) to seed with wself
    self_idx: np.ndarray = None          # (ndiag,) int32 within one channel

    triples: list = field(default_factory=list)

    @property
    def ncoeff(self) -> int:
        """Descriptor width per atom (per type), matching reference ncoeff."""
        n = self.nb_base
        if self.quadraticflag:
            n += self.nb_base * (self.nb_base + 1) // 2
        return n


def build_snap_plan(
    twojmax: int,
    nelements: int = 1,
    chemflag: bool = False,
    bnormflag: bool = False,
    bzeroflag: bool = True,
    wselfallflag: bool = False,
    quadraticflag: bool = False,
    wself: float = 1.0,
) -> SnapPlan:
    offsets, ulen = u_layout(twojmax)
    triples = b_triples(twojmax)
    ntrip = len(triples)

    nchem = nelements if chemflag else 1

    i1l, i2l, i3l, coefl, tidl = [], [], [], [], []

    cg_cache = {}

    def cgb(j1, j2, j):
        key = (j1, j2, j)
        if key not in cg_cache:
            cg_cache[key] = cg_block(j1, j2, j)
        return cg_cache[key]

    # Per-(j1,j2,j) z-sum structure, folded into flat trilinear terms.
    # B_t = 2 * sum_{mb: 2mb<j} sum_{ma} Re[conj(u_j[mb,ma]) z(ma,mb)]
    #     + (j even) 2*sum_{ma<j/2} ... + 1.0 * (ma=mb=j/2 term)
    base_terms = []  # (t, coef, (j1,mb1,ma1), (j2,mb2,ma2), (j,mb,ma))
    for t, (j1, j2, j) in enumerate(triples):
        cg = cgb(j1, j2, j)
        bnorm = 1.0 / (j + 1) if bnormflag else 1.0

        def zterms(ma, mb):
            """(coef, idx1, idx2) contributions to z(j1,j2,j,ma,mb)."""
            ma1min = max(0, (2 * ma - j - j2 + j1) // 2)
            ma1max = min(j1, (2 * ma - j + j2 + j1) // 2)
            mb1min = max(0, (2 * mb - j - j2 + j1) // 2)
            mb1max = min(j1, (2 * mb - j + j2 + j1) // 2)
            out = []
            for mb1 in range(mb1min, mb1max + 1):
                mb2 = (2 * mb - j - (2 * mb1 - j1) + j2) // 2
                for ma1 in range(ma1min, ma1max + 1):
                    ma2 = (2 * ma - j - (2 * ma1 - j1) + j2) // 2
                    c = cg[ma1, ma2] * cg[mb1, mb2]
                    if c != 0.0:
                        out.append((c, (j1, mb1, ma1), (j2, mb2, ma2)))
            return out

        for mb in range(0, j // 2 + 1):
            for ma in range(j + 1):
                if 2 * mb < j:
                    w = 2.0
                elif j % 2 == 0 and mb == j // 2:
                    if ma < mb:
                        w = 2.0
                    elif ma == mb:
                        w = 1.0
                    else:
                        continue  # unused upper part of the middle row
                else:
                    continue
                for c, p1, p2 in zterms(ma, mb):
                    base_terms.append((t, w * c * bnorm, p1, p2, (j, mb, ma)))

    # Expand over element channels.
    for e1 in range(nchem):
        for e2 in range(nchem):
            for e3 in range(nchem):
                itrip = (e1 * nchem + e2) * nchem + e3
                for (t, c, (ja, mba, maa), (jb, mbb, mab), (jc, mbc, mac)) in base_terms:
                    i1l.append(e1 * ulen + _uidx(offsets, ja, mba, maa))
                    i2l.append(e2 * ulen + _uidx(offsets, jb, mbb, mab))
                    i3l.append(e3 * ulen + _uidx(offsets, jc, mbc, mac))
                    coefl.append(c)
                    tidl.append(itrip * ntrip + t)

    nb_base = ntrip * nchem ** 3

    # Dense contraction matrix: per element-triple block the terms are
    # identical, so one (nterms_base, ntriples) matrix with coefficients
    # folded in turns the segment-sum into a matmul (MXU-friendly; avoids
    # XLA scatter in both forward and backward).
    ntb = len(base_terms)
    mmat = np.zeros((ntb, ntrip), dtype=np.float64)
    for k, (t, c, _, _, _) in enumerate(base_terms):
        mmat[k, t] = c

    # bzero (subtracted from B when bzeroflag), LAMMPS convention:
    # bzero[j] = wself^3 * (bnormflag ? 1 : j+1); with chemflag only the
    # (e,e,e) diagonal triples are shifted unless wselfallflag.
    bzero = np.zeros(nb_base, dtype=np.float64)
    www = wself * wself * wself
    for e1 in range(nchem):
        for e2 in range(nchem):
            for e3 in range(nchem):
                itrip = (e1 * nchem + e2) * nchem + e3
                diag = e1 == e2 == e3
                for t, (j1, j2, j) in enumerate(triples):
                    val = www * (1.0 if bnormflag else (j + 1))
                    if chemflag and not wselfallflag and not diag:
                        val = 0.0
                    bzero[itrip * ntrip + t] = val

    # Quadratic extension indices (combinations_with_replacement order).
    iq1, iq2, qcoef = [], [], []
    if quadraticflag:
        for a in range(nb_base):
            for b in range(a, nb_base):
                iq1.append(a)
                iq2.append(b)
                qcoef.append(0.5 if a == b else 1.0)

    # ---- y-list plan (dB/dutot without autodiff), single-channel case ----
    # z-list over ALL idxz triples (j1 >= j2, every j in the triangle range),
    # FULL (mb, ma) grids (the 2mb>j half is generated by the same term
    # formula; its value equals the symmetry image, keeping the contraction
    # with full `du` tensors a plain dense dot).
    z_dense = y_src = y_fac = None
    if True:  # y-list plan (channel pairing for chem handled in the kernel)
        z_triples = []
        for j1 in range(twojmax + 1):
            for j2 in range(j1 + 1):
                for j in range(j1 - j2, min(twojmax, j1 + j2) + 1, 2):
                    z_triples.append((j1, j2, j))

        def _znnz(t3):
            """Nonzero CG entries of one side of the triple's dense tensor."""
            j1, j2, j = t3
            cg = cgb(j1, j2, j)
            shift = (j1 + j2 - j) // 2
            n = 0
            for m in range(j + 1):
                for m1 in range(j1 + 1):
                    m2 = m + shift - m1
                    if 0 <= m2 <= j2 and cg[m1, m2] != 0.0:
                        n += 1
            return n

        # Sort triples by descending term count (count = nnz_mb * nnz_ma) so
        # the grouped term-GEMM tables below pad contiguous runs; y_src is
        # built against this same order, so the flat z layout stays coherent.
        z_triples.sort(key=lambda t3: _znnz(t3) ** 2, reverse=True)
        zoff = {}
        nz = 0
        for t3 in z_triples:
            zoff[t3] = nz
            nz += (t3[2] + 1) ** 2

        # Dense CG tensor per triple: C[m, m1, m2] = cg[m1, m2] when the
        # projection constraint m1 + m2 = m + (j1+j2-j)/2 holds, else 0.
        # z[mb, ma] = sum_{mb1 mb2 ma1 ma2} C[mb,mb1,mb2] C[ma,ma1,ma2]
        #             u1[mb1,ma1] u2[mb2,ma2]
        # ALL triples are padded to a common (D, D, D) grid (D = jmax+1) and
        # stacked, so the whole z-list is 8 batched einsums — keeping the
        # XLA graph tiny and the work MXU/VPU-batched.
        D = twojmax + 1
        ntz = len(z_triples)
        z_cpad = np.zeros((ntz, D, D, D))
        zg1 = np.zeros((ntz, D, D), np.int32)
        zg2 = np.zeros((ntz, D, D), np.int32)
        for t, (j1, j2, j) in enumerate(z_triples):
            cg = cgb(j1, j2, j)
            bnorm = 1.0 / (j + 1) if bnormflag else 1.0
            shift = (j1 + j2 - j) // 2
            for m in range(j + 1):
                for m1 in range(j1 + 1):
                    m2 = m + shift - m1
                    if 0 <= m2 <= j2:
                        # fold bnorm once (C appears twice in the product)
                        z_cpad[t, m, m1, m2] = cg[m1, m2] * bnorm
            # restore: bnorm must multiply z once, not twice — use sqrt? No:
            # apply bnorm only on the 'mb' factor side below.
            for mb1 in range(j1 + 1):
                for ma1 in range(j1 + 1):
                    zg1[t, mb1, ma1] = _uidx(offsets, j1, mb1, ma1)
            for mb2 in range(j2 + 1):
                for ma2 in range(j2 + 1):
                    zg2[t, mb2, ma2] = _uidx(offsets, j2, mb2, ma2)
        # second (un-normalized) C for the mb-side contraction
        z_cpad_raw = np.zeros((ntz, D, D, D))
        for t, (j1, j2, j) in enumerate(z_triples):
            cg = cgb(j1, j2, j)
            shift = (j1 + j2 - j) // 2
            for m in range(j + 1):
                for m1 in range(j1 + 1):
                    m2 = m + shift - m1
                    if 0 <= m2 <= j2:
                        z_cpad_raw[t, m, m1, m2] = cg[m1, m2]
        z_dense = {"C_ma": z_cpad, "C_mb": z_cpad_raw,
                   "g1": zg1, "g2": zg2, "D": D, "ntz": ntz}

        # ---- grouped term tables: z as gather + product + batched GEMM ----
        # The einsum chain over (ntz, D, D, D) tensors tiles terribly on TPU
        # (trailing dims <= D pad to 128-lane tiles).  Instead enumerate the
        # nonzero CG*CG product terms per triple and reduce them with a
        # t-batched (A, P) x (P, D^2) dot: atoms ride the MXU's M dimension,
        # the contraction axis is the padded term list.  Triples are already
        # sorted by term count; contiguous runs share one power-of-two pad.
        def _pad128(n):
            return max(128, 1 << (int(n) - 1).bit_length())

        counts = []
        nz_mb, nz_ma = [], []
        for t in range(ntz):
            mb_list = [tuple(ix) for ix in np.argwhere(z_cpad_raw[t] != 0)]
            ma_list = [tuple(ix) for ix in np.argwhere(z_cpad[t] != 0)]
            nz_mb.append(mb_list)
            nz_ma.append(ma_list)
            counts.append(len(mb_list) * len(ma_list))
        z_groups = []
        t0g = 0
        while t0g < ntz:
            P = _pad128(counts[t0g])
            t1g = t0g + 1
            while t1g < ntz and _pad128(counts[t1g]) * 2 > P:
                t1g += 1
            Tg = t1g - t0g
            gi1 = np.zeros((Tg, P), np.int32)
            gi2 = np.zeros((Tg, P), np.int32)
            M = np.zeros((Tg, P, D * D))
            for ti, t in enumerate(range(t0g, t1g)):
                k = 0
                for (n, mb1, mb2) in nz_mb[t]:
                    wb = z_cpad_raw[t, n, mb1, mb2]
                    for (m, ma1, ma2) in nz_ma[t]:
                        gi1[ti, k] = zg1[t, mb1, ma1]
                        gi2[ti, k] = zg2[t, mb2, ma2]
                        M[ti, k, n * D + m] = wb * z_cpad[t, m, ma1, ma2]
                        k += 1
            z_groups.append({"gi1": gi1, "gi2": gi2, "M": M})
            t0g = t1g
        z_dense["groups"] = z_groups

        # Assemble dB/dutot rows: for B-triple (J1,J2,J) the jacobian is the
        # z-list at (J1,J2,J) in the u_J block, plus (J,J2,J1) in the u_J1
        # block scaled by (J+1)/(J1+1), plus (J,J1,J2) in the u_J2 block
        # scaled by (J+1)/(J2+1)  [factors 1 under bnormflag].
        y_src = np.zeros((3, ntrip, ulen), np.int32)
        y_fac = np.zeros((3, ntrip, ulen), np.float64)
        for t, (J1, J2, J) in enumerate(triples):
            blocks = [
                ((J1, J2, J), J, 1.0),
                ((J, J2, J1), J1,
                 1.0 if bnormflag else (J + 1) / (J1 + 1)),
                ((J, J1, J2), J2,
                 1.0 if bnormflag else (J + 1) / (J2 + 1)),
            ]
            zpos = {t3: i for i, t3 in enumerate(z_triples)}
            for layer, (zt, jp, fac) in enumerate(blocks):
                base = zpos[zt] * D * D
                for mb in range(jp + 1):
                    for ma in range(jp + 1):
                        p = _uidx(offsets, jp, mb, ma)
                        y_src[layer, t, p] = base + mb * D + ma
                        y_fac[layer, t, p] = fac

    # Self-term diagonal indices within a channel.
    self_idx = []
    for j in range(twojmax + 1):
        for ma in range(j + 1):
            self_idx.append(_uidx(offsets, j, ma, ma))

    plan = SnapPlan(
        twojmax=twojmax,
        nelements=nelements,
        chemflag=chemflag,
        bnormflag=bnormflag,
        bzeroflag=bzeroflag,
        wselfallflag=wselfallflag,
        quadraticflag=quadraticflag,
        u_offsets=offsets,
        u_len=ulen,
        i1=np.asarray(i1l, dtype=np.int32),
        i2=np.asarray(i2l, dtype=np.int32),
        i3=np.asarray(i3l, dtype=np.int32),
        coef=np.asarray(coefl, dtype=np.float64),
        tid=np.asarray(tidl, dtype=np.int32),
        mmat=mmat,
        ntriples=ntrip,
        nblocks=nchem ** 3,
        nb_base=nb_base,
        bzero=bzero,
        iq1=np.asarray(iq1, dtype=np.int32),
        iq2=np.asarray(iq2, dtype=np.int32),
        qcoef=np.asarray(qcoef, dtype=np.float64),
        z_dense=z_dense, y_src=y_src, y_fac=y_fac,
        self_idx=np.asarray(self_idx, dtype=np.int32),
        triples=triples,
    )
    return plan


def rootpq_tables(twojmax: int):
    """Static per-level coefficient tables for the U recursion.

    For level j, returns (ca, cb) of shape (j+1, j+1) indexed [mb, ma]:
      ca[mb, ma] = sqrt((j - ma) / (j - mb))   (conj(a) term)
      cb[mb, ma] = sqrt(ma / (j - mb))         (conj(b) term)
    Rows with 2*mb > j are unused (filled by symmetry) and set to 0.
    """
    tables = []
    for j in range(1, twojmax + 1):
        ca = np.zeros((j + 1, j + 1))
        cb = np.zeros((j + 1, j + 1))
        for mb in range(0, j // 2 + 1):
            for ma in range(j + 1):
                if ma < j:
                    ca[mb, ma] = sqrt((j - ma) / (j - mb))
                if ma > 0:
                    cb[mb, ma] = sqrt(ma / (j - mb))
        tables.append((ca, cb))
    return tables


def sym_signs(twojmax: int):
    """(-1)^(ma+mb) sign grids used by the U symmetry completion."""
    out = []
    for j in range(1, twojmax + 1):
        mb = np.arange(j + 1)[:, None]
        ma = np.arange(j + 1)[None, :]
        out.append(np.where((ma + mb) % 2 == 0, 1.0, -1.0))
    return out
