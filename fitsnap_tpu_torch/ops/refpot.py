"""Reference (subtracted) potentials in PyTorch: `zero`, `zbl`, `hybrid/overlay`.

Counterpart of `fitsnap_tpu/ops/refpot.py`.  The ZBL pair energy and its
gradient dE/dD come in closed form from kernel K5 (`zbl_pair_grad`); the
force scatter and virial run through the row-scatter kernel K4 with a
gradient of width 1.

ZBL follows LAMMPS `pair_style zbl` (metal units): universal screening
function plus a C1-smooth switching polynomial between the inner and outer
cutoffs, with the constant shift sw5 making E(outer) = 0.

`coul/cut` and `spin/exchange/biquadratic` parse but are not ported yet
(ROADMAP.md, queue 1: coul/spin references).
"""

from dataclasses import dataclass

import numpy as np
import torch

from fitsnap_tpu_torch.kernels import snap_kernels as sk

# LAMMPS pair_zbl constants (metal units)
_PZBL = 0.23
_A0 = 0.46850
_C = np.array(sk.ZBL_C)
_D = np.array(sk.ZBL_D)
_QQR2E = 14.399645  # eV*A

_NOT_PORTED = ("reference pair style {} is not ported to fitsnap_tpu_torch "
               "yet (ROADMAP.md, queue 1: coul/spin references)")


def _e_zbl_np(r, zi, zj):
    a = _A0 / (zi ** _PZBL + zj ** _PZBL)
    pre = _QQR2E * zi * zj
    x = r / a
    phi = (_C * np.exp(-_D * x)).sum()
    return pre / r * phi


def _de_zbl_np(r, zi, zj):
    a = _A0 / (zi ** _PZBL + zj ** _PZBL)
    pre = _QQR2E * zi * zj
    x = r / a
    phi = (_C * np.exp(-_D * x)).sum()
    dphi = (-(_C * _D) * np.exp(-_D * x)).sum() / a
    return -pre / r ** 2 * phi + pre / r * dphi


def _d2e_zbl_np(r, zi, zj):
    a = _A0 / (zi ** _PZBL + zj ** _PZBL)
    pre = _QQR2E * zi * zj
    x = r / a
    phi = (_C * np.exp(-_D * x)).sum()
    dphi = (-(_C * _D) * np.exp(-_D * x)).sum() / a
    d2phi = ((_C * _D * _D) * np.exp(-_D * x)).sum() / a ** 2
    return 2 * pre / r ** 3 * phi - 2 * pre / r ** 2 * dphi + pre / r * d2phi


@dataclass(frozen=True)
class ZblParams:
    """Per-type-pair ZBL tables (ntypes, ntypes)."""
    cut_inner: float
    cut_outer: float
    zi: np.ndarray
    zj: np.ndarray
    sw3: np.ndarray
    sw4: np.ndarray
    sw5: np.ndarray
    active: np.ndarray  # bool mask of coeff'd type pairs


def build_zbl(cut_inner, cut_outer, pair_z, ntypes):
    """pair_z: dict {(ti, tj) 0-based: (Zi, Zj)}; wildcarded pairs expanded."""
    zi = np.zeros((ntypes, ntypes))
    zj = np.zeros((ntypes, ntypes))
    active = np.zeros((ntypes, ntypes), bool)
    for (ti, tj), (a, b) in pair_z.items():
        zi[ti, tj] = zi[tj, ti] = a
        zj[ti, tj] = zj[tj, ti] = b
        active[ti, tj] = active[tj, ti] = True
    sw3 = np.zeros((ntypes, ntypes))
    sw4 = np.zeros((ntypes, ntypes))
    sw5 = np.zeros((ntypes, ntypes))
    tc = cut_outer - cut_inner
    for ti in range(ntypes):
        for tj in range(ntypes):
            if not active[ti, tj]:
                continue
            fc = _e_zbl_np(cut_outer, zi[ti, tj], zj[ti, tj])
            fcp = _de_zbl_np(cut_outer, zi[ti, tj], zj[ti, tj])
            fcpp = _d2e_zbl_np(cut_outer, zi[ti, tj], zj[ti, tj])
            swa = (-3.0 * fcp + tc * fcpp) / tc ** 2
            swb = (2.0 * fcp - tc * fcpp) / tc ** 3
            sw3[ti, tj] = swa / 3.0
            sw4[ti, tj] = swb / 4.0
            sw5[ti, tj] = -fc - sw3[ti, tj] * tc ** 3 - sw4[ti, tj] * tc ** 4
    return ZblParams(cut_inner, cut_outer, zi, zj, sw3, sw4, sw5, active)


def zbl_table(p: ZblParams, device):
    """(T, T, 6) float64 rows (pre, a, sw3, sw4, sw5, active) per type pair:
    the prefactor qqr2e Zi Zj, the screening length and the switching
    coefficients that K5 reads."""
    a = _A0 / np.where(p.active, p.zi ** _PZBL + p.zj ** _PZBL, 1.0)
    table = np.stack([_QQR2E * p.zi * p.zj, a, p.sw3, p.sw4, p.sw5,
                      p.active.astype(np.float64)], -1)
    return torch.as_tensor(table, dtype=torch.float64, device=device)


@dataclass(frozen=True)
class SpinExchangeParams:
    """LAMMPS `pair_style spin/exchange/biquadratic` (Bethe-Slater radial
    profiles): parsed here, evaluated in a later slice."""
    rc: float
    aj: float
    gj: float
    dj: float
    ak: float
    gk: float
    dk: float
    offset: bool = True


@dataclass(frozen=True)
class CoulCutParams:
    """LAMMPS `pair_style coul/cut <rc>`: parsed here, evaluated in a later
    slice."""
    rc: float


@dataclass(frozen=True)
class RefSpec:
    """Parsed REFERENCE section: list of active pair potentials."""
    zbl: ZblParams = None
    spin: SpinExchangeParams = None
    coul: CoulCutParams = None
    max_cutoff: float = 0.0


def parse_reference(section, ntypes) -> RefSpec:
    """Parse `pair_style` / `pair_coeff` declarations (reference section
    forwards them verbatim to LAMMPS; we interpret the supported subset)."""
    decls = section.lmp_pairdecl
    style_line = decls[0].split()
    assert style_line[0] == "pair_style"
    styles = {}
    toks = style_line[1:]
    if toks[0] == "hybrid/overlay":
        i = 1
        while i < len(toks):
            name = toks[i]
            args = []
            i += 1
            while i < len(toks):
                try:
                    args.append(float(toks[i]))
                    i += 1
                except ValueError:
                    break
            styles[name] = args
    else:
        name = toks[0]
        styles[name] = [float(x) for x in toks[1:] if _is_num(x)]

    for name in styles:
        if name not in ("zero", "zbl", "spin/exchange/biquadratic",
                        "coul/cut"):
            raise NotImplementedError(f"reference pair style '{name}' not supported")

    zbl_pairs = {}
    spin = None
    for line in decls[1:]:
        toks = line.split()
        assert toks[0] == "pair_coeff"
        ti_s, tj_s = toks[1], toks[2]
        rest = toks[3:]
        # hybrid: next token names the sub-style
        style = rest[0] if rest and not _is_num(rest[0]) else None
        args = rest[1:] if style else rest
        if style == "zbl" or (style is None and "zbl" in styles
                              and len(styles) == 1):
            t_is = range(ntypes) if ti_s == "*" else [int(ti_s) - 1]
            t_js = range(ntypes) if tj_s == "*" else [int(tj_s) - 1]
            for a in t_is:
                for b in t_js:
                    zbl_pairs[(a, b)] = (float(args[0]), float(args[1]))
        elif style == "spin/exchange/biquadratic":
            # biquadratic <rc> aJ gJ dJ aK gK dK [offset yes|no]
            assert args[0] == "biquadratic"
            vals = args[1:8]
            offset = True
            if "offset" in args:
                offset = args[args.index("offset") + 1].lower() in (
                    "yes", "true", "1")
            spin = SpinExchangeParams(
                rc=float(vals[0]), aj=float(vals[1]), gj=float(vals[2]),
                dj=float(vals[3]), ak=float(vals[4]), gk=float(vals[5]),
                dk=float(vals[6]), offset=offset)

    zbl = None
    coul = None
    max_cut = 0.0
    if "zbl" in styles:
        cut_inner, cut_outer = styles["zbl"][0], styles["zbl"][1]
        zbl = build_zbl(cut_inner, cut_outer, zbl_pairs, ntypes)
        max_cut = max(max_cut, cut_outer)
    if "coul/cut" in styles:
        coul = CoulCutParams(rc=float(styles["coul/cut"][0]))
        max_cut = max(max_cut, coul.rc)
    if spin is not None:
        max_cut = max(max_cut, spin.rc)
    return RefSpec(zbl=zbl, spin=spin, coul=coul, max_cutoff=max_cut)


def _is_num(s):
    try:
        float(s)
        return True
    except ValueError:
        return False


def reference_eav(disp, jidx, mask, rev, types, spec: RefSpec, plain=False):
    """Reference-potential energy, forces and virial of a batch of configs.

    disp (C, A, K, 3) = r_j - r_i over the directed padded neighbor list
    (each physical pair appears twice, so pair sums carry a 0.5 factor);
    jidx, mask (C, A, K); rev (C, A, R) reverse neighbor table; types (C, A)
    int32.  Returns energy (C,), forces (C, A, 3) and virial (C, 6) ordered
    (xx, yy, zz, yz, xz, xy), W_ab = -sum D_a dE/dD_b.  `plain=True` runs the
    plain versions of K5 and K4 on any device.
    """
    C, A = mask.shape[:2]
    if spec.coul is not None:
        raise NotImplementedError(_NOT_PORTED.format("coul/cut"))
    if spec.spin is not None:
        raise NotImplementedError(
            _NOT_PORTED.format("spin/exchange/biquadratic"))
    if spec.zbl is None:
        return (disp.new_zeros(C), disp.new_zeros((C, A, 3)),
                disp.new_zeros((C, 6)))

    table = zbl_table(spec.zbl, disp.device)
    zbl = sk.zbl_pair_grad_plain if plain else sk.zbl_pair_grad
    g, energy = zbl(disp, jidx, mask, types, table, spec.zbl.cut_inner,
                    spec.zbl.cut_outer)
    scatter = sk.pair_scatter_rows_plain if plain else sk.pair_scatter_rows
    zeros = torch.zeros_like(types)
    force, virial = scatter(g[:, :, None], disp, mask, rev, zeros, 1)
    return energy, force.reshape(C, A, 3), virial.reshape(C, 6)
