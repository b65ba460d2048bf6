"""Default ACE hyperparameters from element radii.

Behavioral analog of the reference's `tools/default_ACE_settings.py`:
estimate per-bond radial cutoffs from tabulated radii and emit ready
[ACE]-section strings plus a suggested [REFERENCE] ZBL block.  The recipe
(reference `default_ACE_settings.py:23-172`):

  - per bond (e1, e2): min bond length = sum of ionic radii (x0.8 when a
    metal is involved); max = sum of vdW radii (nonmetal pairs),
    ionic+vdW (metal-nonmetal) or ionic sum (metal-metal);
  - rcut = nshell * (min + max) / 1.8,  lambda = 0.05 * rcut,
    rcinner = 0.25 * min bond, drcinner = 0.01;
  - ZBL inner/outer picked just inside the shortest bond.

Radii sources (public tables): ionic radii in crystals, Slater 1964;
van der Waals radii, Bondi 1964 (nonmetals; elements without a Bondi value
fall back to twice the ionic radius).  The reference pulls the same
quantities from `ase.data`; small numerical differences are expected and
immaterial — these are starting points for hyperparameter search, not
physics.

Usage:
    from fitsnap_tpu_torch.tools.ace_defaults import default_ace_settings
    d = default_ace_settings(["In", "P"], nshell=2.2)
    print(d["rcutfac"], d["lambda"], d["rcinner"], d["drcinner"])
    print(d["reference"])      # suggested [REFERENCE] ZBL section

Copy of `fitsnap_tpu/tools/ace_defaults.py`.
"""

from itertools import product

import numpy as np

# Slater (1964) ionic radii in crystals, angstroms.
IONIC_RADII = {
    'H': 0.25, 'He': 1.2, 'Li': 1.45, 'Be': 1.05, 'B': 0.85, 'C': 0.7,
    'N': 0.65, 'O': 0.6, 'F': 0.5, 'Ne': 1.6, 'Na': 1.8, 'Mg': 1.5,
    'Al': 1.25, 'Si': 1.1, 'P': 1.0, 'S': 1.0, 'Cl': 1.0, 'Ar': 0.71,
    'K': 2.2, 'Ca': 1.8, 'Sc': 1.6, 'Ti': 1.4, 'V': 1.35, 'Cr': 1.4,
    'Mn': 1.4, 'Fe': 1.4, 'Co': 1.35, 'Ni': 1.35, 'Cu': 1.35, 'Zn': 1.35,
    'Ga': 1.3, 'Ge': 1.25, 'As': 1.15, 'Se': 1.15, 'Br': 1.15, 'Rb': 2.35,
    'Sr': 2.0, 'Y': 1.8, 'Zr': 1.55, 'Nb': 1.45, 'Mo': 1.45, 'Tc': 1.35,
    'Ru': 1.3, 'Rh': 1.35, 'Pd': 1.4, 'Ag': 1.6, 'Cd': 1.55, 'In': 1.55,
    'Sn': 1.45, 'Sb': 1.45, 'Te': 1.4, 'I': 1.4, 'Cs': 2.6, 'Ba': 2.15,
    'La': 1.95, 'Ce': 1.85, 'Pr': 1.85, 'Nd': 1.85, 'Pm': 1.85, 'Sm': 1.85,
    'Eu': 1.85, 'Gd': 1.8, 'Tb': 1.75, 'Dy': 1.75, 'Ho': 1.75, 'Er': 1.75,
    'Tm': 1.75, 'Yb': 1.75, 'Lu': 1.75, 'Hf': 1.55, 'Ta': 1.45, 'W': 1.35,
    'Re': 1.35, 'Os': 1.3, 'Ir': 1.35, 'Pt': 1.35, 'Au': 1.35, 'Hg': 1.5,
    'Tl': 1.9, 'Pb': 1.8, 'Bi': 1.6, 'Po': 1.9, 'Ra': 2.15, 'Ac': 1.95,
    'Th': 1.8, 'Pa': 1.8, 'U': 1.75, 'Np': 1.75, 'Pu': 1.75, 'Am': 1.75,
}

# Bondi (1964) van der Waals radii, angstroms (elements with a value).
VDW_RADII = {
    'H': 1.20, 'He': 1.40, 'Li': 1.82, 'C': 1.70, 'N': 1.55, 'O': 1.52,
    'F': 1.47, 'Ne': 1.54, 'Na': 2.27, 'Mg': 1.73, 'Si': 2.10, 'P': 1.80,
    'S': 1.80, 'Cl': 1.75, 'Ar': 1.88, 'K': 2.75, 'Ni': 1.63, 'Cu': 1.40,
    'Zn': 1.39, 'Ga': 1.87, 'As': 1.85, 'Se': 1.90, 'Br': 1.85, 'Kr': 2.02,
    'Pd': 1.63, 'Ag': 1.72, 'Cd': 1.58, 'In': 1.93, 'Sn': 2.17, 'Te': 2.06,
    'I': 1.98, 'Xe': 2.16, 'Pt': 1.75, 'Au': 1.66, 'Hg': 1.55, 'Tl': 1.96,
    'Pb': 2.02, 'U': 1.86,
}

METALS = {
    'Li', 'Be', 'Na', 'Mg', 'K', 'Ca', 'Sc', 'Ti', 'V', 'Cr', 'Mn', 'Fe',
    'Co', 'Ni', 'Cu', 'Zn', 'Rb', 'Sr', 'Y', 'Zr', 'Nb', 'Mo', 'Tc', 'Ru',
    'Rh', 'Pd', 'Ag', 'Cd', 'Cs', 'Ba', 'Lu', 'Hf', 'Ta', 'W', 'Re', 'Os',
    'Ir', 'Pt', 'Au', 'Hg', 'Fr', 'La', 'Ce', 'Pr', 'Nd', 'Pm', 'Sm', 'Eu',
    'Gd', 'Tb', 'Dy', 'Ho', 'Er', 'Yb', 'Ac', 'Th', 'Pa', 'U', 'Np', 'Pu',
    'Am', 'Al',
}

ATOMIC_NUMBERS = {s: i + 1 for i, s in enumerate(
    "H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca Sc Ti V Cr Mn Fe "
    "Co Ni Cu Zn Ga Ge As Se Br Kr Rb Sr Y Zr Nb Mo Tc Ru Rh Pd Ag Cd In "
    "Sn Sb Te I Xe Cs Ba La Ce Pr Nd Pm Sm Eu Gd Tb Dy Ho Er Tm Yb Lu Hf "
    "Ta W Re Os Ir Pt Au Hg Tl Pb Bi Po At Rn Fr Ra Ac Th Pa U Np Pu Am"
    .split())}


def _vdw(e):
    return VDW_RADII.get(e, 2.0 * IONIC_RADII[e])


def bond_lengths(e1, e2, metal_max=True):
    """(min, max) estimated bond lengths for the (e1, e2) pair.

    Mirrors the reference's `default_rc` branch-for-branch
    (`tools/default_ACE_settings.py:23-67`), including its asymmetric
    handling of metal+nonmetal pairs after alphabetical sorting: when the
    METAL sorts first (Ta-C), max = ionic(metal) + vdW(nonmetal) and min is
    scaled by 0.8; when the NONMETAL sorts first (N-W), max falls through
    to the ionic sum with no 0.8 scaling — so migrating users get the same
    suggestions the reference script prints.
    """
    e1, e2 = sorted((e1, e2))
    ion1, ion2 = IONIC_RADII[e1], IONIC_RADII[e2]
    m1, m2 = e1 in METALS, e2 in METALS
    minb = ion1 + ion2
    if metal_max:
        if not m1 and not m2:
            maxb = _vdw(e1) + _vdw(e2)
        elif m1 and not m2:
            maxb = ion1 + _vdw(e2)
            minb = (ion1 + ion2) * 0.8
        elif m1 and m2:
            maxb = ion1 + ion2
            minb = (ion1 + ion2) * 0.8
        else:
            maxb = ion1 + ion2
    else:
        maxb = _vdw(e1) + _vdw(e2)
    return round(minb, 3), round(maxb, 3)


def default_ace_settings(elems, nshell=2.2, metal_max=True,
                         inner_fraction=0.25):
    """Per-bond [ACE] defaults + a suggested [REFERENCE] ZBL block.

    `elems` must be sorted alphabetically (the bond order of the ACE
    section is itertools.product(types, types)).  Returns a dict with
    'rcutfac'/'lambda'/'rcinner'/'drcinner' strings (ready for the [ACE]
    section), 'rc_range' per bond, and 'reference' (multi-line string with
    pair_style/pair_coeff suggestions).
    """
    if list(elems) != sorted(elems):
        raise ValueError("elements must be listed alphabetically")
    bonds = list(product(elems, elems))
    rc_range, rc, rcin = {}, {}, {}
    for b in bonds:
        mn, mx = bond_lengths(b[0], b[1], metal_max)
        rc_range[b] = (mn, mx)
        rc[b] = nshell * (mn + mx) / 1.8
        rcin[b] = inner_fraction * mn
    lmb = {b: 0.05 * rc[b] for b in bonds}

    def fmtrow(d):
        return "  ".join(f"{d[b]:1.3f}" for b in bonds)

    # ZBL suggestion: inner just inside the shortest estimated bond,
    # outer just inside the hard-core region, per unordered pair
    ubonds = [b for b in bonds if b == tuple(sorted(b))]
    zbl, coeffs = [], ["pair_coeff1 = * * zero"]
    idx = {e: i + 1 for i, e in enumerate(elems)}
    for k, b in enumerate(ubonds):
        inner = max(0.7 * rc_range[b][0], rcin[b] + 0.05)
        outer = 0.8 * rc[b] / nshell
        zbl.append(f"zbl {inner:.3f} {outer:.3f}")
        z1, z2 = ATOMIC_NUMBERS[b[0]], ATOMIC_NUMBERS[b[1]]
        sub = f"zbl {k + 1} " if len(ubonds) > 1 else "zbl "
        coeffs.append(f"pair_coeff{k + 2} = {idx[b[0]]} {idx[b[1]]} "
                      f"{sub}{z1} {z2}")
    ref = "\n".join(
        [f"pair_style = hybrid/overlay zero "
         f"{max(rc.values()) + 0.01:.3f} " + " ".join(zbl)] + coeffs)

    return {
        "rcutfac": fmtrow(rc),
        "lambda": fmtrow(lmb),
        "rcinner": fmtrow(rcin),
        "drcinner": "  ".join("0.010" for _ in bonds),
        "rc_range": rc_range,
        "reference": ref,
    }
