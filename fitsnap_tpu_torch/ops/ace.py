"""ACE (Atomic Cluster Expansion) descriptors in PyTorch.

Counterpart of `fitsnap_tpu/ops/ace.py`.

  - host side (copied): rotation-invariant product-basis labels
    (mu0, mu_vec, n_vec, l_vec, L_vec), their generalized coupling
    coefficients, and the packed plan (`AcePlan`: A-basis slots, term
    tables), from an [ACE] section (`build_ace_plan`, with the reference
    bases of `ops/ace_ref_basis.py`) or from a `.yace` file
    (`plan_from_yace`, which needs PyYAML);
  - device side (plain PyTorch): ChebExpCos radial basis, complex
    spherical harmonics, per-pair basis phi and its neighbor sum A, the
    multilinear products B and their leave-one-out jacobian dB/dA.  These
    are the plain versions of the kernels K13 (per-pair basis, A and the
    tangents) and K14 (B and dB/dD) of `kernels/ace_kernels.py`, and the
    CPU path.

`ace_descriptors_with_jacobian` takes `plain=` as
`ops/snap.descriptors_with_jacobian` does: for a CUDA tensor it launches
K13 and K14.  With `FITSNAP_TPU_ACE_SPLINE=<delta>` in the environment (the
JAX package's variable) a plan evaluates its radials from cubic Hermite
spline tables of bin width delta, as ML-PACE does (`_hermite_radial_table`,
`spline_radial_basis`).
"""

import itertools
import os
from dataclasses import dataclass, field
from functools import lru_cache
from math import sqrt
from types import SimpleNamespace

import numpy as np
import torch

from fitsnap_tpu_torch.ops.cg import cg_block


# ---------------------------------------------------------------------------
# host-side: labels and couplings
# ---------------------------------------------------------------------------

def _cg(l1, m1, l2, m2, L, M):
    """<l1 m1 l2 m2 | L M> from the 2j-integer cg_block tables."""
    if m1 + m2 != M:
        return 0.0
    blk = cg_block(2 * l1, 2 * l2, 2 * L)
    return float(blk[m1 + l1, m2 + l2])


def coupling_terms(lvec, Lvec):
    """All (m-vector, coefficient) pairs coupling Ylm products to a scalar.

    Left-fold scheme: (((l1 l2) L1 l3) L2 ... l_{r-1}) L_{r-2}, then the
    final CG with l_r couples to (0, 0), requiring L_{r-2} == l_r.
    """
    r = len(lvec)
    if r == 1:
        assert lvec[0] == 0
        return {(0,): 1.0}
    if r == 2:
        l = lvec[0]
        assert lvec[1] == l
        out = {}
        for m in range(-l, l + 1):
            out[(m, -m)] = (-1.0) ** (l - m) / sqrt(2 * l + 1)
        return out

    inter = list(Lvec)
    assert len(inter) == r - 2
    terms = {}

    def recurse(slot, mprefix, Lcur, Mcur, coef):
        if slot == r - 1:
            # final scalar contraction with l_r: <L M l_r m | 0 0>
            l_last = lvec[-1]
            if Lcur != l_last:
                return
            m_last = -Mcur
            if abs(m_last) > l_last:
                return
            c = ((-1.0) ** (l_last - Mcur)) / sqrt(2 * l_last + 1)
            key = mprefix + (m_last,)
            terms[key] = terms.get(key, 0.0) + coef * c
            return
        l_next = lvec[slot]
        L_next = inter[slot - 1]
        for m in range(-l_next, l_next + 1):
            M2 = Mcur + m
            if abs(M2) > L_next:
                continue
            c = _cg(Lcur, Mcur, l_next, m, L_next, M2)
            if c != 0.0:
                recurse(slot + 1, mprefix + (m,), L_next, M2, coef * c)

    l1, l2 = lvec[0], lvec[1]
    L1 = inter[0] if r > 2 else lvec[-1]
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            M = m1 + m2
            if abs(M) > L1:
                continue
            c = _cg(l1, m1, l2, m2, L1, M)
            if c != 0.0:
                recurse(2, (m1, m2), L1, M, c)
    # drop numerically-zero sets
    return {k: v for k, v in terms.items() if abs(v) > 1e-14}


def _scalar_cg_sign(L, M, l, m):
    return (-1.0) ** (l - m) / sqrt(2 * l + 1) if (M + m) == 0 else 0.0


def generate_labels(ranks, nmax, lmax, numtypes, lmin=None):
    """Enumerate (mu0, mus, ns, ls, Ls) labels.

    Per rank r: (mu, n, l) slot triples from combinations_with_replacement
    (permutation-invariant ordering), l in [lmin_r..lmax_r] for r >= 2
    (rank 1 is l = 0), sum(l) even, all triangle-valid intermediate L-paths.
    """
    lmin = lmin or [0] * len(ranks)
    if len(lmin) == 1:
        lmin = list(lmin) * len(ranks)
    assert len(lmin) == len(ranks) == len(nmax) == len(lmax), \
        "per-rank hyperparameter lists must have equal length"
    labels = []
    for mu0 in range(numtypes):
        for rank, nmx, lmx, lmn in zip(ranks, nmax, lmax, lmin):
            if rank == 1:
                for mu in range(numtypes):
                    for n in range(1, nmx + 1):
                        labels.append((mu0, (mu,), (n,), (0,), ()))
                continue
            lrange = range(lmn, lmx + 1) if rank > 1 else [0]
            slots = [(mu, n, l)
                     for mu in range(numtypes)
                     for n in range(1, nmx + 1)
                     for l in lrange]
            for combo in itertools.combinations_with_replacement(slots, rank):
                ls = tuple(s[2] for s in combo)
                if sum(ls) % 2 != 0:
                    continue
                mus = tuple(s[0] for s in combo)
                ns = tuple(s[1] for s in combo)
                # enumerate valid intermediate L paths (left fold)
                def lpaths(Lcur, idx, path):
                    if idx == rank - 1:
                        if Lcur == ls[-1]:
                            yield path
                        return
                    for L in range(abs(Lcur - ls[idx]), Lcur + ls[idx] + 1):
                        yield from lpaths(L, idx + 1, path + (L,))
                if rank == 2:
                    if ls[0] == ls[1]:
                        labels.append((mu0, mus, ns, ls, ()))
                    continue
                for Ls in lpaths(ls[0], 1, ()):
                    # skip odd-parity intermediates relative to coupling
                    labels.append((mu0, mus, ns, ls, Ls[1:] if False else Ls))
    # dedupe
    seen = set()
    out = []
    for lab in labels:
        if lab not in seen:
            seen.add(lab)
            out.append(lab)
    return out


@dataclass
class AcePlan:
    """Static parameterization of the ACE kernel."""
    numtypes: int
    nradbase: int
    nmax_per_l: dict            # l -> max n used
    lmax: int
    rcut: np.ndarray = None      # (numtypes, numtypes) per-bond cutoffs
    lmbda: np.ndarray = None     # (numtypes, numtypes) ChebExpCos lambda
    rcinner: np.ndarray = None   # (numtypes, numtypes) inner cutoff
    drcinner: np.ndarray = None  # (numtypes, numtypes) inner cutoff width
    labels: list = field(default_factory=list)
    # A-basis layout: flat index over (mu, n, l, m)
    a_index: dict = None        # (mu, n, l, m) -> idx
    nA: int = 0
    # term tables
    t_fact: np.ndarray = None   # (nterms, R) int32 indices into A (+1 dummy)
    t_coef: np.ndarray = None   # (nterms,)
    t_label: np.ndarray = None  # (nterms,)
    t_mu0: np.ndarray = None    # (nlabels,) central element of each label
    rank_max: int = 0
    mmat: np.ndarray = None     # (nterms, nlabels) dense agg matrix
    # Conventions default to ML-PACE's (determined against the Ta_PACE
    # standard: rank-1 betas to 0.05%, higher-rank ratios = (4pi)^(rank/2)):
    # radial 'pace_px' = g_1 = env, g_n = (1 - T_{n-1}(x))/2 * env with the
    # increasing exp-scaled x; ylm '4pi' = sqrt(4 pi) * orthonormal Ylm
    # (Y00 = 1).  'v0'/'std' are this framework's original conventions.
    radial: str = "pace_px"     # ChebExpCos convention variant
    ylm: str = "4pi"            # '4pi' | 'std' | 'racah'
    # ML-PACE evaluates radials from cubic Hermite spline lookup tables
    # (deltaSplineBins in the .yace, default 0.001), not the analytic
    # ChebExpCos; the bin width when set (FITSNAP_TPU_ACE_SPLINE)
    spline_delta: float = None
    # per-device tensors of the tables (`plan_tensors`) and the kernels'
    # host-built tables (`kernels/ace_kernels.py`), built at first use
    tables: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def ncoeff(self):
        return len(self.labels) // self.numtypes


def _bond_matrix(vals, numtypes):
    """Per-bond parameter matrix from 1, numtypes^2 values, or a matrix.

    The reference orders bond values as itertools.product(types, types)
    (calculator_sections/ace.py rcutfac/lambda/rcinner/drcinner lists)."""
    a = np.asarray(vals, float).reshape(-1)
    if a.size == 1:
        return np.full((numtypes, numtypes), float(a[0]))
    if a.size == numtypes * numtypes:
        return a.reshape(numtypes, numtypes)
    raise ValueError(
        f"expected 1 or {numtypes * numtypes} bond values, got {a.size}")


def _pack_plan(labels, terms_per_label, numtypes, nradbase, lmax,
               rcut, lmbda, rcinner, drcinner) -> AcePlan:
    """Assemble an AcePlan from labels + per-label {m-vector: ctilde} maps.

    Rank-1 slots use the ML-PACE convention: the descriptor is the plain
    radial-base sum sum_j g_n(r_j) with NO Y00 factor (that is why .yace
    files carry nradbasemax >= nradmax and rank-1 ns beyond nradmax).
    Those factors are keyed (mu, n, -1, 0) in the A-index and evaluated
    without a spherical harmonic.
    """
    used = {}
    for (mu0, mus, ns, ls, Ls) in labels:
        rank = len(mus)
        for mu, n, l in zip(mus, ns, ls):
            key_l = -1 if rank == 1 else l
            used[(mu, n, key_l)] = True
    a_index = {}
    idx = 1                       # 0 is the dummy "one" slot
    for (mu, n, l) in sorted(used):
        for m in ([0] if l < 0 else range(-l, l + 1)):
            a_index[(mu, n, l, m)] = idx
            idx += 1
    nA = idx

    rank_max = max(len(lab[1]) for lab in labels)
    t_fact, t_coef, t_label = [], [], []
    for li, (mu0, mus, ns, ls, Ls) in enumerate(labels):
        rank = len(mus)
        for mvec, c in terms_per_label[li].items():
            fact = [a_index[(mu, n, -1 if rank == 1 else l, m)]
                    for mu, n, l, m in zip(mus, ns, ls, mvec)]
            fact += [0] * (rank_max - len(fact))
            t_fact.append(fact)
            t_coef.append(c)
            t_label.append(li)

    nterms = len(t_fact)
    nlabels = len(labels)
    mmat = np.zeros((nterms, nlabels))
    for k, (li, c) in enumerate(zip(t_label, t_coef)):
        mmat[k, li] = c

    nmax_per_l = {}
    for (mu, n, l) in used:
        nmax_per_l[l] = max(nmax_per_l.get(l, 0), n)

    return AcePlan(
        numtypes=numtypes,
        nradbase=nradbase,
        nmax_per_l=nmax_per_l,
        lmax=lmax,
        rcut=_bond_matrix(rcut, numtypes),
        lmbda=_bond_matrix(lmbda, numtypes),
        rcinner=_bond_matrix(rcinner, numtypes),
        drcinner=_bond_matrix(drcinner, numtypes),
        labels=labels,
        a_index=a_index,
        nA=nA,
        t_fact=np.asarray(t_fact, np.int32),
        t_coef=np.asarray(t_coef),
        t_label=np.asarray(t_label, np.int32),
        t_mu0=np.asarray([lab[0] for lab in labels], np.int32),
        rank_max=rank_max,
        mmat=mmat,
        spline_delta=(float(os.environ["FITSNAP_TPU_ACE_SPLINE"])
                      if os.environ.get("FITSNAP_TPU_ACE_SPLINE")
                      else None),
    )


def build_ace_plan(section) -> AcePlan:
    ranks = section.ranks
    nmax = section.nmax
    lmax_list = section.lmax
    lmin = section.lmin
    numtypes = section.numtypes
    basis = getattr(section, "b_basis", "native")
    if basis in ("minsub", "pa_tabulated"):
        from fitsnap_tpu_torch.ops.ace_ref_basis import reference_labels_and_terms
        labels, terms = reference_labels_and_terms(section)
    else:
        labels = generate_labels(ranks, nmax, lmax_list, numtypes, lmin)
        terms = [coupling_terms(lab[3], lab[4]) for lab in labels]
    return _pack_plan(
        labels, terms, numtypes,
        nradbase=max(section.nmaxbase, max(nmax)),
        lmax=max(lmax_list),
        rcut=section.rcutfac,
        lmbda=section.lmbda,
        rcinner=section.rcinner,
        drcinner=section.drcinner,
    )


def plan_terms(plan: AcePlan):
    """Per-label {m-vector: ctilde} maps recovered from the packed term
    tables (inverse of _pack_plan; used by the .yace writer)."""
    inv = {v: k for k, v in plan.a_index.items()}
    terms = [dict() for _ in plan.labels]
    for fact, coef, li in zip(plan.t_fact, plan.t_coef, plan.t_label):
        rank = len(plan.labels[li][1])
        mvec = tuple(int(inv[int(f)][3]) for f in fact[:rank])
        terms[li][mvec] = terms[li].get(mvec, 0.0) + float(coef)
    return terms


def plan_from_yace(path) -> AcePlan:
    """Build an evaluation plan from an ML-PACE ctilde potential
    (`coupling_coefficients.yace` or a fitted `.yace`).

    Covers the reference's `manuallabs`-style workflows and provides an
    exact-basis oracle: descriptors evaluated with a plan loaded from the
    reference's own coupling file must reproduce `compute pace` outputs
    (reference lammps_pace.py:71-84 consumes the same file).
    """
    import re

    import yaml

    with open(path) as f:
        txt = f.read()
    # bond keys are flow-style lists ([0, 0]:) — unhashable for safe_load
    txt = re.sub(r"^(\s+)(\[[\d,\s]+\]):", r'\1"\2":', txt, flags=re.M)
    doc = yaml.safe_load(txt)
    elements = doc["elements"]
    numtypes = len(elements)
    bond = next(iter(doc["bonds"].values()))
    # validate EVERY bond block, not just the first: a multi-element .yace
    # with per-bond differing nradbase or non-identity radcoefficients must
    # not load silently with the wrong radial basis
    for key, b in doc["bonds"].items():
        assert int(b["nradbasemax"]) == int(bond["nradbasemax"]), (
            f"bond {key}: nradbasemax {b['nradbasemax']} differs from "
            f"{bond['nradbasemax']} (per-bond radial sizes unsupported)")
        crad = np.asarray(b["radcoefficients"], float)
        eye = np.zeros_like(crad)
        for n in range(crad.shape[0]):
            eye[n, :, n] = 1.0
        assert np.allclose(crad, eye), (
            f"bond {key}: only identity radcoefficients (R_nl = g_n) "
            "are supported")
    nt = numtypes
    rc = np.zeros((nt, nt))
    lam = np.zeros((nt, nt))
    rc_in = np.zeros((nt, nt))
    d_in = np.full((nt, nt), 0.01)
    for key, b in doc["bonds"].items():
        i, j = (int(x) for x in re.findall(r"\d+", str(key)))
        rc[i, j] = float(b["rcut"])
        lam[i, j] = float(b["radparameters"][0])
        rc_in[i, j] = float(b.get("rcut_in", 0.0) or 0.0)
        d_in[i, j] = float(b.get("dcut_in", 0.01) or 0.01)
    labels = []
    terms = []
    lmax = 0
    for mu0 in sorted(doc["functions"]):
        for fn in doc["functions"][mu0]:
            rank = int(fn["rank"])
            mus = tuple(int(x) for x in fn["mus"])
            ns = tuple(int(x) for x in fn["ns"])
            ls = tuple(int(x) for x in fn["ls"])
            lmax = max(lmax, max(ls))
            ms = [int(x) for x in fn["ms_combs"]]
            cts = [float(x) for x in fn["ctildes"]]
            tmap = {}
            for k, c in enumerate(cts):
                mvec = tuple(ms[k * rank:(k + 1) * rank])
                tmap[mvec] = tmap.get(mvec, 0.0) + c
            labels.append((int(mu0), mus, ns, ls, ()))
            terms.append(tmap)
    return _pack_plan(
        labels, terms, numtypes,
        nradbase=int(bond["nradbasemax"]),
        lmax=lmax,
        rcut=rc,
        lmbda=lam,
        rcinner=rc_in,
        drcinner=d_in,
    )


def plan_tensors(plan: AcePlan, device):
    """The plan's bond and term tables as tensors on `device`, built once
    per device and kept on the plan."""
    device = torch.device(device)
    key = str(device)
    tabs = plan.tables.get(key)
    if tabs is None:
        def f64(x):
            return torch.as_tensor(np.asarray(x, np.float64), device=device)

        tabs = SimpleNamespace(
            rcut=f64(plan.rcut), lmbda=f64(plan.lmbda),
            rcinner=f64(plan.rcinner), drcinner=f64(plan.drcinner),
            t_fact=torch.as_tensor(np.asarray(plan.t_fact, np.int64),
                                   device=device),
            t_coef=f64(plan.t_coef),
            t_label=torch.as_tensor(np.asarray(plan.t_label, np.int64),
                                    device=device),
            t_mu0=torch.as_tensor(np.asarray(plan.t_mu0, np.int64),
                                  device=device),
            mmat=f64(plan.mmat))
        plan.tables[key] = tabs
    return tabs


# ---------------------------------------------------------------------------
# device side, plain PyTorch
# ---------------------------------------------------------------------------

def chebexpcos_basis(r, rcut, lmbda, nradbase, variant="v0"):
    """ChebExpCos radial functions g_k(r), k = 1..nradbase (the values of
    `_radial_and_derivative`); `rcut` and `lmbda` broadcast against r."""
    rcut = torch.as_tensor(rcut, dtype=r.dtype, device=r.device) \
        .broadcast_to(r.shape)
    lmbda = torch.as_tensor(lmbda, dtype=r.dtype, device=r.device) \
        .broadcast_to(r.shape)
    return _radial_and_derivative(r, rcut, lmbda, nradbase, variant)[0]


def sph_harm(disp_unit, lmax):
    """Complex spherical harmonics Y_lm for l<=lmax, m=-l..l, orthonormal
    (the values of `_ylm_and_gradient` with ylm='std').

    Returns (yr, yi) lists indexed [l][..., 2l+1] (m = -l..l).
    """
    r = torch.ones_like(disp_unit[..., 0])
    yr, yi, _, _ = _ylm_and_gradient(disp_unit, r, lmax, "std")
    return ([yr[..., l * l:(l + 1) ** 2] for l in range(lmax + 1)],
            [yi[..., l * l:(l + 1) ** 2] for l in range(lmax + 1)])


def ace_pair_phi(disp, jelem, mask, ielem, plan: AcePlan):
    """Per-pair basis contributions phi (A_atoms, K, nA) complex pair (the
    values of `pair_phi_tangents`).

    Column layout matches `plan.a_index` (index 0 is a constant ZERO slot
    here; the A-basis adds the constant 1 after the neighbor sum).
    """
    phi, _ = pair_phi_tangents(disp, jelem, mask, ielem, plan)
    return phi[..., :plan.nA], phi[..., plan.nA:]


def _radial_and_derivative(r, rcut, lmbda, nradbase, variant):
    """ChebExpCos radial functions g (..., nradbase) and dg/dr, in closed
    form: the Chebyshev recursion carried with its derivative.

    Exponentially-scaled Chebyshev polynomials under a cosine cutoff
    (Drautz-2019 Eq. 24).  `variant` selects the exact convention:
      v0: x = 1 - 2 (e^{lambda(1 - r/rc)} - 1)/(e^lambda - 1),
          g_k = T_{k-1}(x) * 0.5 (1 + cos(pi r/rc))
      pace_x: x = 1 - 2 (e^{lambda r/rc} - 1)/(e^lambda - 1) (ML-PACE
          ace_radial scaled distance), same g stack
      v0_t1 / pace_x_t1: same x, g_k = T_k(x) (skip the constant T_0)
      pace_px / pace_mx: ML-PACE radbase, g_1 = env,
          g_n = 0.5 (1 - T_{n-1}(+-x)) env
    """
    x0 = torch.clamp(r / rcut, 0.0, 1.0)
    den = torch.exp(lmbda) - 1.0
    if variant.startswith("pace_x"):
        el = torch.exp(lmbda * x0)
        dx = -2.0 * lmbda * el / den / rcut
    else:
        el = torch.exp(lmbda * (1.0 - x0))
        dx = 2.0 * lmbda * el / den / rcut
    x = 1.0 - 2.0 * (el - 1.0) / den
    dx = torch.where((x < -1.0) | (x > 1.0), torch.zeros_like(dx), dx)
    x = torch.clamp(x, -1.0, 1.0)
    cz = 0.5 * (1.0 + torch.cos(torch.pi * x0))
    dcz = -0.5 * torch.pi * torch.sin(torch.pi * x0) / rcut
    # every "pace*" variant but pace_px takes -x
    sign = -1.0 if variant.startswith("pace") and variant != "pace_px" \
        else 1.0
    xs, dxs = sign * x, sign * dx
    # T_k(xs) and dT_k/dr, k = 0..nradbase
    T, dT = [torch.ones_like(xs), xs], [torch.zeros_like(xs), dxs]
    for _ in range(2, nradbase + 1):
        (tm, tc), (dtm, dtc) = T[-2:], dT[-2:]
        T.append(2.0 * xs * tc - tm)
        dT.append(2.0 * dxs * tc + 2.0 * xs * dtc - dtm)
    if variant.startswith("pace"):
        h = [torch.ones_like(xs)] + [0.5 * (1.0 - T[n - 1])
                                     for n in range(2, nradbase + 1)]
        dh = [torch.zeros_like(xs)] + [-0.5 * dT[n - 1]
                                       for n in range(2, nradbase + 1)]
    else:
        k0 = 1 if variant.endswith("_t1") else 0
        h, dh = T[k0:k0 + nradbase], dT[k0:k0 + nradbase]
    h, dh = torch.stack(h, -1), torch.stack(dh, -1)
    inside = (r < rcut)[..., None]
    zero = torch.zeros_like(h)
    g = torch.where(inside, h * cz[..., None], zero)
    dg = torch.where(inside, dh * cz[..., None] + h * dcz[..., None], zero)
    return g, dg


@lru_cache(maxsize=None)
def _hermite_radial_table(rcut, lmbda, nradbase, variant, delta):
    """Cubic-Hermite spline coefficients of the radial basis (host numpy).

    Emulates ML-PACE's SplineInterpolator: node values and derivatives at
    spacing `delta` (from `_radial_and_derivative`), evaluated per bin as a
    cubic in t = r/delta - n.  Returns (nlut, nradbase, 4) float64 [c0, c1,
    c2, c3], nlut = ceil(rcut/delta) + 1.  At the node r = 0 both clamps of
    the scaled distance sit at their bounds, where the JAX package's
    derivative (`jax.jvp`) takes half of each side: its node derivative
    there is a quarter of the closed form's (the cutoff factor's part is
    zero, sin 0 = 0), and so is this table's.
    """
    nlut = int(np.ceil(rcut / delta)) + 1
    rs = torch.arange(nlut + 1, dtype=torch.float64)[:, None] * delta
    full = torch.ones_like(rs)
    g, dg = _radial_and_derivative(rs, full * rcut, full * lmbda, nradbase,
                                   variant)
    vals, dvals = g[:, 0].numpy(), dg[:, 0].numpy().copy()
    dvals[0] *= 0.25
    f0, f1 = vals[:-1], vals[1:]
    d0, d1 = dvals[:-1] * delta, dvals[1:] * delta
    c2 = -3.0 * f0 - 2.0 * d0 + 3.0 * f1 - d1
    c3 = 2.0 * f0 + d0 - 2.0 * f1 + d1
    return np.stack([f0, d0, c2, c3], axis=-1)


def spline_tables(plan: AcePlan):
    """(numtypes^2, nlut_max, nradbase, 4) float64 host table of the
    plan's spline radials, bond ielem * numtypes + jelem (each bond's
    `_hermite_radial_table`, zero past its own bins); kept on the plan."""
    tab = plan.tables.get("spline")
    if tab is None:
        tabs = [_hermite_radial_table(float(rc), float(lam), plan.nradbase,
                                      plan.radial, float(plan.spline_delta))
                for rc, lam in zip(np.ravel(plan.rcut), np.ravel(plan.lmbda))]
        tab = np.zeros((len(tabs), max(t.shape[0] for t in tabs))
                       + tabs[0].shape[1:])
        for i, t in enumerate(tabs):
            tab[i, :t.shape[0]] = t
        plan.tables["spline"] = tab
    return tab


def spline_tensor(plan: AcePlan, device):
    """`spline_tables` as a float64 tensor on `device`, kept on the plan
    (the plain radials and kernel K13 read the same one)."""
    key = f"spline:{torch.device(device)}"
    tab = plan.tables.get(key)
    if tab is None:
        tab = plan.tables[key] = torch.as_tensor(spline_tables(plan),
                                                 device=device)
    return tab


def spline_radial_basis(r, bond_idx, rcm, plan: AcePlan):
    """Spline-table radials g (..., nradbase) and dg/dr at r with per-bond
    tables (`spline_tables`, bond_idx = ielem * numtypes + jelem), zero at
    or beyond the bond's cutoff rcm: the JAX package's
    `spline_radial_basis` (:483) with its r derivative, ((3 c3 t + 2 c2) t
    + c1) / delta (the floor of the bin has zero derivative)."""
    delta = float(plan.spline_delta)
    tab = spline_tensor(plan, r.device)
    x = r / delta
    n = torch.clamp(torch.floor(x), 0, tab.shape[1] - 1)
    t = (x - n)[..., None]
    c = tab[bond_idx.long(), n.long()]                 # (..., nradbase, 4)
    c0, c1, c2, c3 = c.unbind(-1)
    g = ((c3 * t + c2) * t + c1) * t + c0
    dg = ((3.0 * c3 * t + 2.0 * c2) * t + c1) / delta
    inside = (r < rcm)[..., None]
    zero = torch.zeros_like(g)
    return torch.where(inside, g, zero), torch.where(inside, dg, zero)


def _ylm_and_gradient(unit, r, lmax, ylm):
    """Yhat_lm in the `ylm` convention at the unit vectors, (..., (lmax+1)^2)
    real and imaginary parts at l*l + l + m, and their gradients with
    respect to the displacement, (3, ..., (lmax+1)^2) each: the gradient of
    the polynomial form c P_lm(z) (x + i y)^m taken through
    d(unit)/dD = (I - u u^T) / r."""
    import math

    x, y, z = unit.unbind(-1)
    P = {(0, 0): torch.ones_like(z)}
    dP = {(0, 0): torch.zeros_like(z)}
    for m in range(1, lmax + 1):
        P[(m, m)] = P[(m - 1, m - 1)] * (2 * m - 1)
        dP[(m, m)] = torch.zeros_like(z)
    for m in range(0, lmax):
        P[(m + 1, m)] = z * (2 * m + 1) * P[(m, m)]
        dP[(m + 1, m)] = (2 * m + 1) * P[(m, m)]
    for m in range(0, lmax + 1):
        for l in range(m + 2, lmax + 1):
            P[(l, m)] = ((2 * l - 1) * z * P[(l - 1, m)]
                         - (l + m - 1) * P[(l - 2, m)]) / (l - m)
            dP[(l, m)] = ((2 * l - 1) * (P[(l - 1, m)] + z * dP[(l - 1, m)])
                          - (l + m - 1) * dP[(l - 2, m)]) / (l - m)
    er, ei = [torch.ones_like(z)], [torch.zeros_like(z)]
    for m in range(1, lmax + 1):
        pr, pi = er[-1], ei[-1]
        er.append(pr * x - pi * y)
        ei.append(pr * y + pi * x)
    ny = (lmax + 1) ** 2
    yr, yi = [None] * ny, [None] * ny
    dyr, dyi = [None] * ny, [None] * ny
    for l in range(lmax + 1):
        scale = {"4pi": math.sqrt(4.0 * math.pi),
                 "racah": math.sqrt(4.0 * math.pi / (2 * l + 1))}.get(ylm, 1.0)
        for m in range(l + 1):
            c = scale * (-1.0) ** m * math.sqrt(
                (2 * l + 1) / (4 * math.pi)
                * math.factorial(l - m) / math.factorial(l + m))
            pl, dpl = c * P[(l, m)], c * dP[(l, m)]
            vr, vi = pl * er[m], pl * ei[m]
            zero = torch.zeros_like(z)
            if m > 0:
                gr = [pl * m * er[m - 1], -pl * m * ei[m - 1], dpl * er[m]]
                gi = [pl * m * ei[m - 1], pl * m * er[m - 1], dpl * ei[m]]
            else:
                gr, gi = [zero, zero, dpl * er[m]], [zero, zero, dpl * ei[m]]
            gr, gi = torch.stack(gr), torch.stack(gi)          # (3, ...)
            tr = (gr - unit.movedim(-1, 0) * (unit.movedim(-1, 0) * gr)
                  .sum(0)) / r
            ti = (gi - unit.movedim(-1, 0) * (unit.movedim(-1, 0) * gi)
                  .sum(0)) / r
            ip = l * l + l + m
            yr[ip], yi[ip], dyr[ip], dyi[ip] = vr, vi, tr, ti
            if m > 0:
                # Y_{l,-m} = (-1)^m conj(Y_lm)
                s = (-1.0) ** m
                ip = l * l + l - m
                yr[ip], yi[ip], dyr[ip], dyi[ip] = s * vr, -s * vi, s * tr, \
                    -s * ti
    return (torch.stack(yr, -1), torch.stack(yi, -1), torch.stack(dyr, -1),
            torch.stack(dyi, -1))


def slot_table(plan: AcePlan):
    """(nA, 4) int32 numpy table of the A-slots: (mu, n, l, m) of each slot
    (l = -1: a rank-1 radial slot); slot 0, the constant, is (-1, 0, 0, 0).
    Kept on the plan."""
    slot = plan.tables.get("slot")
    if slot is None:
        slot = np.zeros((plan.nA, 4), np.int32)
        slot[0] = (-1, 0, 0, 0)
        for (mu, n, l, m), idx in plan.a_index.items():
            slot[idx] = (mu, n, l, m)
        plan.tables["slot"] = slot
    return slot


def pair_phi_tangents(disp, jelem, mask, ielem, plan: AcePlan):
    """phi as [Re | Im] (A, K, 2nA) with its three displacement tangents
    Jp (3, A, K, 2nA) = d phi / d disp[..., c], in closed form (the
    arithmetic of kernel K13): g_n'(r) from the Chebyshev recursion carried
    with its derivative, the Ylm gradient through d(unit)/dD = (I - u u^T)
    / r.  Masked pairs take the displacement (1, 0, 0) and weight 0, so
    their phi and tangents are exactly zero.  A plan with `spline_delta`
    takes g and g' from its spline tables (`spline_radial_basis`)."""
    dtype, dev = disp.dtype, disp.device
    tabs = plan_tensors(plan, dev)
    safe = torch.where(mask[..., None], disp, disp.new_tensor([1.0, 0.0, 0.0]))
    r = torch.sqrt(torch.sum(safe * safe, -1))
    unit = safe / r[..., None]
    ie, je = ielem.long()[:, None], jelem.long()
    if plan.spline_delta:
        g, dg = spline_radial_basis(r, ie * plan.numtypes + je,
                                    tabs.rcut[ie, je], plan)
    else:
        g, dg = _radial_and_derivative(r, tabs.rcut[ie, je],
                                       tabs.lmbda[ie, je], plan.nradbase,
                                       plan.radial)
    if np.any(np.asarray(plan.rcinner) > 0.0):
        din = torch.clamp(tabs.drcinner[ie, je], min=1e-12)
        t = (r - (tabs.rcinner[ie, je] - tabs.drcinner[ie, je])) / din
        ramp = (t > 0.0) & (t < 1.0)
        t = torch.clamp(t, 0.0, 1.0)
        fin = (0.5 * (1.0 - torch.cos(torch.pi * t)))[..., None]
        dfin = torch.where(ramp,
                           0.5 * torch.pi * torch.sin(torch.pi * t) / din,
                           torch.zeros_like(t))[..., None]
        g, dg = g * fin, dg * fin + g * dfin
    live = mask[..., None].to(dtype)
    g, dg = g * live, dg * live
    yr, yi, dyr, dyi = _ylm_and_gradient(unit, r, plan.lmax, plan.ylm)
    # rank-1 radial slots (l = -1) read a constant 1 appended to the Ylm
    one, zero = torch.ones_like(r)[..., None], torch.zeros_like(r)[..., None]
    yr, yi = torch.cat([yr, one], -1), torch.cat([yi, zero], -1)
    dyr = torch.cat([dyr, zero.expand((3,) + zero.shape)], -1)
    dyi = torch.cat([dyi, zero.expand((3,) + zero.shape)], -1)

    slot = torch.as_tensor(slot_table(plan)[1:].astype(np.int64), device=dev)
    mu, n, l, m = slot.unbind(-1)
    ip = torch.where(l < 0, (plan.lmax + 1) ** 2, l * l + l + m)
    chan = (je[..., None] == mu).to(dtype)                   # (A, K, nA - 1)
    base, dbase = g[..., n - 1] * chan, dg[..., n - 1] * chan
    sr, si = yr[..., ip], yi[..., ip]
    u = unit.movedim(-1, 0)[..., None]                       # (3, A, K, 1)
    jr = dbase * u * sr + base * dyr[..., ip]
    ji = dbase * u * si + base * dyi[..., ip]
    z1 = torch.zeros_like(base[..., :1])
    phi = torch.cat([z1, base * sr, z1, base * si], -1)
    z3 = torch.zeros_like(jr[..., :1])
    return phi, torch.cat([z3, jr, z3, ji], -1)


def ace_a_basis(disp, jelem, mask, ielem, plan: AcePlan):
    """A-basis: (A_atoms, nA) complex pair (index 0 is the constant 1), as
    `kernels/ace_kernels.ace_pair_basis_plain` gives it."""
    from fitsnap_tpu_torch.kernels import ace_kernels as ak

    A, _ = ak.ace_pair_basis_plain(disp, jelem, mask, ielem, plan)
    return A[..., :plan.nA], A[..., plan.nA:]


def ace_descriptors_with_jacobian(disp, jelem, mask, ielem, plan: AcePlan,
                                  plain=False):
    """Per-atom ACE descriptors and per-pair gradients.

    Returns (B (A, nl), dBdD (A, nl, K, 3)); same contract as the SNAP
    `descriptors_with_jacobian`.  The two steps are the kernels K13 (A and
    the pair tangents) and K14 (B, dB/dA and its contraction into dB/dD,
    labels masked by their central element); `plain=True` runs their plain
    versions on any device.
    """
    from fitsnap_tpu_torch.kernels import ace_kernels as ak

    if plain:
        A, Jp = ak.ace_pair_basis_plain(disp, jelem, mask, ielem, plan)
        return ak.ace_b_dbdd_plain(A, Jp, ielem, plan)
    A, Jp = ak.ace_pair_basis(disp, jelem, mask, ielem, plan)
    return ak.ace_b_dbdd(A, Jp, ielem, plan)


def ace_b_and_dbda(A_r, A_i, plan: AcePlan):
    """B and its analytic jacobian dB/dA via leave-one-out products.

    Returns (B (A, nlabels), dBdA (A, nlabels, 2*nA)) with the real/imag A
    layout [Ar | Ai].  Prefix/suffix complex products give the per-slot
    cofactors; aggregation into (label, A-index) buckets is a segment-sum
    with static sorted-by-label ids.
    """
    dtype = A_r.dtype
    tabs = plan_tensors(plan, A_r.device)
    nbatch = A_r.shape[:-1]
    fact = tabs.t_fact                                     # (T, R)
    R = plan.rank_max
    T = fact.shape[0]
    nA = plan.nA
    nl = len(plan.labels)
    pr = A_r[..., fact]
    pi = A_i[..., fact]
    ones = torch.ones(nbatch + (T,), dtype=dtype, device=A_r.device)
    zeros = torch.zeros_like(ones)
    # prefix[..., r] = prod_{r'<r}, suffix[..., r] = prod_{r'>r}
    pre_r, pre_i = [ones], [zeros]
    for rr in range(1, R):
        ar, ai = pre_r[-1], pre_i[-1]
        pre_r.append(ar * pr[..., rr - 1] - ai * pi[..., rr - 1])
        pre_i.append(ar * pi[..., rr - 1] + ai * pr[..., rr - 1])
    suf_r, suf_i = [ones], [zeros]
    for rr in range(R - 2, -1, -1):
        ar, ai = suf_r[0], suf_i[0]
        suf_r.insert(0, ar * pr[..., rr + 1] - ai * pi[..., rr + 1])
        suf_i.insert(0, ar * pi[..., rr + 1] + ai * pr[..., rr + 1])
    B_r = pre_r[-1] * pr[..., R - 1] - pre_i[-1] * pi[..., R - 1]
    B = B_r @ tabs.mmat

    # cofactor per slot: dprod/dA[f_{t,r}] = prefix * suffix (complex)
    coef = tabs.t_coef
    seg = (tabs.t_label[:, None] * nA + fact).reshape(-1)  # (T*R,)
    loo_r = torch.stack([coef * (pre_r[rr] * suf_r[rr] - pre_i[rr] * suf_i[rr])
                         for rr in range(R)], -1)          # (.., T, R)
    loo_i = torch.stack([coef * (pre_r[rr] * suf_i[rr] + pre_i[rr] * suf_r[rr])
                         for rr in range(R)], -1)
    flat_r = loo_r.reshape(nbatch + (T * R,))
    flat_i = loo_i.reshape(nbatch + (T * R,))
    # d Re[c * prod] / dA_r = Re[cofactor], / dA_i = -Im[cofactor]
    out = torch.zeros(nbatch + (nl * nA,), dtype=dtype, device=A_r.device)
    dBdAr = out.index_add(-1, seg, flat_r)
    dBdAi = out.index_add(-1, seg, -flat_i)
    dBdA = torch.cat([dBdAr.reshape(nbatch + (nl, nA)),
                      dBdAi.reshape(nbatch + (nl, nA))], -1)
    return B, dBdA
