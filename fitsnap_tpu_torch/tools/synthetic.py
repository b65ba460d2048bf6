"""Synthetic training sets in FitSNAP JSON, made from a seed.

The Ta_Linear_JCP2014 training set (363 configs, 15,213 rows) is not in
the repository, so the port's end-to-end checks fit a stand-in with the same
shapes: bcc / fcc / A15 volume scans and strained cells of 2-8 atoms (cells
of 3.3 A edge, so an atom meets its own periodic images within the 4.8 A
cutoff), jittered supercells of 32-128 atoms, and liquid-like 100-atom
cells with a 2.0 A minimum distance, in groups named and weighted as the Ta
example's, some with test fractions.  `ta_settings` holds the
Ta_Linear_JCP2014 sections, `quadratic_settings` the same with twojmax 8
and quadraticflag (the Ta_Quadratic_JCP2018 model's width, 1,596
coefficients), `nn_settings` the same for the NN solver (a per-atom MLP
of widths 64 64 1 on the 30 descriptors), `custom_settings` the custom
pairwise NN on the 31 Bessel / Gaussian 3-body pair descriptors,
`ace_settings` a Ta_PACE-shaped [ACE] section.

The InP_JPCA2020 set is not in the repository either: `inp_configs` makes
zincblende In/P cells (8-atom volume and strain scans, displaced 64- and
216-atom supercells, 64-atom cells with antisite defects, so the mix of
elements varies), and `inp_settings` the example's explicit multi-element
model (chemflag, two elements, wselfallflag, bnormflag, bzeroflag 1,
per-element ESHIFT, ZBL 4.0-4.2 for Z = 49 / 15), `inp_nn_settings` the
same model under the NN solver.

The Fe_Linear_NPJ2021 set is not in the repository: `fe_configs` makes bcc
Fe cells (2-atom volume scans, jittered 16- and 54-atom supercells) whose
JSON carries `Spins` (a moment and a direction near +z per atom) and
`Charges` (small, summing to zero per cell), and `fe_settings` a SNAP
model with the hybrid/overlay reference of zbl, coul/cut and
spin/exchange/biquadratic, which reads both.

Per-atom-scalar (PAS) fits read a per-atom `Chis` key: `with_chis` adds a
seeded smooth one to any of these sets (the JAX package's PAS test's
target, 0.3 sin(sum of the position's coordinates) + 2.0 plus N(0, 0.05)
noise), and `pas_settings` turns `ta_settings`, `inp_settings` or
`ace_settings` into a PAS fit under the NN solver.

`write_dataset` writes zero truths; callers that fit it first compute their
truths (for example A @ beta_true + the reference potential) and rewrite
the files with `config_json`.
"""

import json
from pathlib import Path

import numpy as np

BCC = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]])
FCC = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5],
                [0.0, 0.5, 0.5]])
A15 = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5], [0.25, 0.0, 0.5],
                [0.75, 0.0, 0.5], [0.5, 0.25, 0.0], [0.5, 0.75, 0.0],
                [0.0, 0.5, 0.25], [0.0, 0.5, 0.75]])
LATTICE = {"BCC": (BCC, 3.32), "FCC": (FCC, 4.22), "A15": (A15, 5.27)}
ZINCBLENDE = np.concatenate([FCC, FCC + 0.25])   # 4 In sites, then 4 P
INP_A = 5.87

# group: (training fraction, testing fraction, eweight, fweight, vweight)
TA_GROUPS = {
    "Volume_BCC": (1.0, 0.0, 1.0, 1e-9, 1e-9),
    "Volume_FCC": (0.8, 0.2, 1.0, 1e-9, 1e-9),
    "Volume_A15": (1.0, 0.0, 1.0, 1e-9, 1e-9),
    "Elastic_BCC": (0.8, 0.2, 1e-8, 1e-8, 1e-4),
    "Elastic_FCC": (1.0, 0.0, 1e-9, 1e-9, 1e-9),
    "Displaced_BCC": (0.8, 0.2, 100.0, 1.0, 1e-8),
    "Displaced_FCC": (1.0, 0.0, 100.0, 1.0, 1e-8),
    "Displaced_A15": (1.0, 0.0, 100.0, 1.0, 1e-8),
    "Compressed_BCC": (1.0, 0.0, 100.0, 1.0, 1e-8),
    "Liquid": (0.75, 0.25, 467.0, 1.0, 1e-8),
}
FE_GROUPS = {
    "Volume_BCC": (1.0, 0.0, 1.0, 1e-9, 1e-9),
    "Spin_BCC": (0.8, 0.2, 100.0, 1.0, 1e-8),
    "Displaced_BCC": (1.0, 0.0, 100.0, 1.0, 1e-8),
}
FE_A = 2.83
INP_GROUPS = {
    "Volume_ZB": (1.0, 0.0, 100.0, 1e-9, 1e-9),
    "Strain_ZB": (0.8, 0.2, 1e-8, 1e-8, 1e-4),
    "Displaced_ZB64": (0.8, 0.2, 100.0, 1.0, 1e-8),
    "Displaced_ZB216": (1.0, 0.0, 100.0, 1.0, 1e-8),
    "Antisite_ZB64": (1.0, 0.0, 100.0, 1.0, 1e-8),
}


def supercell(basis, a, reps):
    """Cubic supercell: (positions (n, 3), cell rows (3, 3))."""
    grid = np.stack(np.meshgrid(*[np.arange(r) for r in reps],
                                indexing="ij"), -1).reshape(-1, 3)
    frac = (grid[:, None, :] + basis[None]).reshape(-1, 3) / np.asarray(reps)
    cell = np.diag(np.asarray(reps, float) * a)
    return frac @ cell, cell


def strained(cell, rng, amp):
    """Cell rows times a random lower-triangular strain: the rows stay
    lower-triangular, so the column cell is upper-triangular (the scraper's
    fast path)."""
    eps = np.tril(rng.uniform(-amp, amp, (3, 3)))
    return cell @ (np.eye(3) + eps)


def liquid(rng, natoms, density, dmin):
    """Random periodic positions at `density` (atoms/A^3) with no two atoms
    closer than `dmin`."""
    edge = (natoms / density) ** (1.0 / 3.0)
    pos = []
    while len(pos) < natoms:
        x = rng.uniform(0.0, edge, 3)
        if pos:
            d = np.asarray(pos) - x
            d -= edge * np.round(d / edge)
            if (np.einsum("ij,ij->i", d, d) < dmin * dmin).any():
                continue
        pos.append(x)
    return np.asarray(pos), np.eye(3) * edge


def ta_configs(seed, counts=None):
    """{group: [(positions, cell rows)]} of a Ta-shaped set.

    `counts` scales each group's number of configs ({group: n}); the
    default is the full set of about 360 configs.
    """
    rng = np.random.default_rng(seed)
    full = {"Volume_BCC": 35, "Volume_FCC": 35, "Volume_A15": 35,
            "Elastic_BCC": 50, "Elastic_FCC": 50, "Displaced_BCC": 45,
            "Displaced_FCC": 45, "Displaced_A15": 30, "Compressed_BCC": 16,
            "Liquid": 16}
    counts = full if counts is None else counts
    out = {}
    for group, n in counts.items():
        kind, lat = group.split("_")[0], group.split("_")[-1]
        confs = []
        for i in range(n):
            if kind == "Volume":
                basis, a = LATTICE[lat]
                scale = 0.78 + 0.5 * i / max(n - 1, 1)
                pos, cell = supercell(basis, a * scale, (1, 1, 1))
            elif kind == "Elastic":
                basis, a = LATTICE[lat]
                pos, cell0 = supercell(basis, a, (1, 1, 1))
                cell = strained(cell0, rng, 0.04)
                pos = pos @ np.linalg.solve(cell0, cell)
            elif kind == "Displaced":
                basis, a = LATTICE[lat]
                reps = {"BCC": (3, 3, 3), "FCC": (2, 2, 2), "A15": (2, 2, 2)}
                pos, cell = supercell(basis, a, reps[lat])
                pos = pos + rng.normal(0.0, 0.12, pos.shape)
            elif kind == "Compressed":
                pos, cell = supercell(BCC, rng.uniform(2.70, 2.76), (4, 4, 4))
                pos = pos + rng.normal(0.0, 0.05, pos.shape)
            else:  # Liquid
                pos, cell = liquid(rng, 100, 0.0556, 2.0)
            confs.append((pos, cell))
        out[group] = confs
    return out


def inp_configs(seed, counts=None):
    """{group: [(positions, cell rows, element names)]} of an InP-shaped set.

    Zincblende cells (In on the fcc sites, P on the sites shifted by a/4,
    a = 5.87 A): 8-atom volume scans (0.9-1.1 a) and strained cells, 64-
    and 216-atom supercells jittered by 0.1 A, and 64-atom cells with 1-3
    antisite defects (an In site taken by P or a P site by In).  `counts`
    gives each group's size ({group: n}); the default is 200 configs.
    """
    rng = np.random.default_rng(seed)
    full = {"Volume_ZB": 40, "Strain_ZB": 60, "Displaced_ZB64": 60,
            "Displaced_ZB216": 16, "Antisite_ZB64": 24}
    counts = full if counts is None else counts
    out = {}
    for group, n in counts.items():
        confs = []
        for i in range(n):
            if group == "Volume_ZB":
                scale = 0.9 + 0.2 * i / max(n - 1, 1)
                pos, cell = supercell(ZINCBLENDE, INP_A * scale, (1, 1, 1))
            elif group == "Strain_ZB":
                pos, cell0 = supercell(ZINCBLENDE, INP_A, (1, 1, 1))
                cell = strained(cell0, rng, 0.04)
                pos = pos @ np.linalg.solve(cell0, cell)
            else:
                reps = (3, 3, 3) if group == "Displaced_ZB216" else (2, 2, 2)
                pos, cell = supercell(ZINCBLENDE, INP_A, reps)
                pos = pos + rng.normal(0.0, 0.1, pos.shape)
            names = np.array(["In", "P"])[
                np.tile(np.repeat([0, 1], 4), len(pos) // 8)]
            if group == "Antisite_ZB64":
                flip = rng.choice(len(pos), rng.integers(1, 4), replace=False)
                names[flip] = np.where(names[flip] == "In", "P", "In")
            confs.append((pos, cell, list(names)))
        out[group] = confs
    return out


def fe_configs(seed, counts=None):
    """{group: [(positions, cell rows, element names, extra keys)]} of an
    Fe-shaped set: bcc cells (a = 2.83 A) of 2 atoms scaled 0.9-1.1
    (Volume_BCC), 16 atoms jittered by 0.08 A (Spin_BCC) and 54 atoms
    jittered by 0.1 A (Displaced_BCC).  Every config's extra keys hold
    `Spins` (natoms, 4): a moment of 2.2 and a direction within about 0.3
    rad of +z, and `Charges` (natoms,): N(0, 0.1) less their mean.
    `counts` gives each group's size; the default is 60 configs."""
    rng = np.random.default_rng(seed)
    full = {"Volume_BCC": 20, "Spin_BCC": 24, "Displaced_BCC": 16}
    counts = full if counts is None else counts
    out = {}
    for group, n in counts.items():
        confs = []
        for i in range(n):
            if group == "Volume_BCC":
                scale = 0.9 + 0.2 * i / max(n - 1, 1)
                pos, cell = supercell(BCC, FE_A * scale, (1, 1, 1))
            else:
                reps = (3, 3, 3) if group == "Displaced_BCC" else (2, 2, 2)
                pos, cell = supercell(BCC, FE_A, reps)
                pos = pos + rng.normal(
                    0.0, 0.1 if group == "Displaced_BCC" else 0.08,
                    pos.shape)
            na = len(pos)
            direction = rng.normal(0.0, 0.3, (na, 3)) + [0.0, 0.0, 1.0]
            direction /= np.linalg.norm(direction, axis=1)[:, None]
            q = rng.normal(0.0, 0.1, na)
            extra = {"Spins": np.concatenate(
                [np.full((na, 1), 2.2), direction], 1).tolist(),
                "Charges": (q - q.mean()).tolist()}
            confs.append((pos, cell, ["Fe"] * na, extra))
        out[group] = confs
    return out


def config_json(pos, cell, energy=0.0, forces=None, stress=None, types=None,
                extra=None):
    """FitSNAP JSON text of one config (cell rows = lattice vectors); the
    atoms are Ta unless `types` names them; `extra` adds keys (for
    example per-atom `Spins` and `Charges`)."""
    n = len(pos)
    forces = np.zeros((n, 3)) if forces is None else forces
    stress = np.zeros((3, 3)) if stress is None else stress
    data = {"Positions": np.asarray(pos).tolist(),
            "Lattice": np.asarray(cell).tolist(),
            "AtomTypes": list(types) if types is not None else ["Ta"] * n,
            "NumAtoms": n,
            "Energy": float(energy),
            "Forces": np.asarray(forces).tolist(),
            "Stress": np.asarray(stress).tolist(),
            "PositionsStyle": "angstrom", "LatticeStyle": "angstrom",
            "EnergyStyle": "electronvolt", "ForcesStyle": "electronvoltperangstrom",
            "StressStyle": "bar", **(extra or {})}
    return json.dumps({"Dataset": {"Data": [data]}})


def with_chis(configs, seed):
    """{group: [(pos, cell, element names, extra keys)]}: `configs` (as
    `write_dataset` takes them; Ta atoms where no names are given) with a
    per-atom `Chis` in every config's extra keys, 0.3 sin(x + y + z) +
    0.05 N(0, 1) + 2.0 at each atom's position, the noise drawn from
    `seed` in the groups' and configs' order."""
    rng = np.random.default_rng(seed)
    out = {}
    for group, confs in configs.items():
        out[group] = []
        for conf in confs:
            pos = np.asarray(conf[0])
            names = conf[2] if len(conf) > 2 else ["Ta"] * len(pos)
            extra = dict(conf[3]) if len(conf) > 3 else {}
            extra["Chis"] = (0.3 * np.sin(pos.sum(axis=1))
                             + 0.05 * rng.standard_normal(len(pos))
                             + 2.0).tolist()
            out[group].append((conf[0], conf[1], names, extra))
    return out


def write_dataset(root, configs):
    """Write {group: [(pos, cell), (pos, cell, element names) or (pos, cell,
    element names, extra keys)]} as root/<group>/<group>_<i>.json with zero
    truths (Ta atoms where no names are given); returns {(group, file
    name): the config's tuple}."""
    files = {}
    for group, confs in configs.items():
        (Path(root) / group).mkdir(parents=True, exist_ok=True)
        for i, conf in enumerate(confs):
            name = f"{group}_{i}.json"
            (Path(root) / group / name).write_text(config_json(
                conf[0], conf[1], types=conf[2] if len(conf) > 2 else None,
                extra=conf[3] if len(conf) > 3 else None))
            files[(group, name)] = conf
    return files


def ta_settings(datapath, groups=None):
    """Input sections of the Ta_Linear_JCP2014 example for `datapath`."""
    groups = TA_GROUPS if groups is None else groups
    table = {g: " ".join(str(v) for v in TA_GROUPS[g]) for g in groups}
    return {
        "BISPECTRUM": {
            "numTypes": 1, "twojmax": 6, "rcutfac": 4.67637,
            "rfac0": 0.99363, "rmin0": 0.0, "wj": 1.0, "radelem": 0.5,
            "type": "Ta", "wselfallflag": 0, "chemflag": 0, "bzeroflag": 0,
            "quadraticflag": 0},
        "CALCULATOR": {"calculator": "LAMMPSSNAP", "energy": 1, "force": 1,
                       "stress": 1},
        "ESHIFT": {"Ta": 0.0},
        "SOLVER": {"solver": "SVD", "compute_testerrs": 1},
        "SCRAPER": {"scraper": "JSON"},
        "PATH": {"dataPath": str(datapath)},
        "OUTFILE": {"metrics": "Ta_metrics.md", "potential": "Ta_pot"},
        "REFERENCE": {
            "units": "metal", "atom_style": "atomic",
            "pair_style": "hybrid/overlay zero 10.0 zbl 4.0 4.8",
            "pair_coeff1": "* * zero", "pair_coeff2": "* * zbl 73 73"},
        "GROUPS": dict({
            "group_sections": "name training_size testing_size eweight "
                              "fweight vweight",
            "group_types": "str float float float float float",
            "smartweights": 0, "random_sampling": 0}, **table),
        "EXTRAS": {}, "MEMORY": {},
    }


def quadratic_settings(datapath, groups=None):
    """`ta_settings` with the Ta_Quadratic_JCP2018 model's width: twojmax 8
    and quadraticflag 1 (55 base + 1,540 quadratic descriptor columns, with
    bzeroflag 0 1,596 coefficients).  The other values are the
    Ta_Linear_JCP2014 example's."""
    s = ta_settings(datapath, groups)
    s["BISPECTRUM"].update(twojmax=8, quadraticflag=1)
    s["OUTFILE"]["potential"] = "Ta_quad_pot"
    return s


def nn_settings(datapath, groups=None, dgrad_mode="precompute"):
    """`ta_settings` for the NN solver: nonlinear 1 and a [PYTORCH] section
    with the config default layer_sizes `num_desc 64 64 1`, batch_size 4,
    multi_element_option 1, manual_seed_flag 1, `dgrad_mode` (precompute
    unless given), energy_weight 1e-2 and force_weight 1.0 (the JAX
    package's NN tests' weights), 10 epochs at the default learning rate
    1e-4."""
    s = ta_settings(datapath, groups)
    s["CALCULATOR"]["nonlinear"] = 1
    s["SOLVER"] = {"solver": "PYTORCH"}
    s["PYTORCH"] = {"layer_sizes": "num_desc 64 64 1", "batch_size": 4,
                    "num_epochs": 10, "energy_weight": 1e-2,
                    "force_weight": 1.0, "multi_element_option": 1,
                    "manual_seed_flag": 1, "dgrad_mode": dgrad_mode,
                    "output_file": "Ta_nn.pt"}
    s["OUTFILE"] = {"metrics": "Ta_nn_metrics.md", "potential": "Ta_nn_pot"}
    return s


def custom_settings(datapath, groups=None, multi_element=False):
    """The custom pairwise NN (calculator LAMMPSCUSTOM, nonlinear 1) for
    `datapath`: a [CUSTOM] section at the config defaults (num_radial 8,
    num_3body 23, cutoff 5.0: 31 pair descriptors) with type Ta, the
    [PYTORCH] section of `nn_settings` (`num_desc 64 64 1`, batch 4, 10
    epochs, seed 13, output_file) and CUSTOM output, on `ta_configs`'
    groups.  With `multi_element`, the two-element variant for
    `inp_configs`: types In and P, `inp_settings`' groups, ESHIFT and ZBL
    reference, and multi_element_option 2 (a network per element)."""
    if multi_element:
        s = inp_settings(datapath, groups)
        s["PYTORCH"] = nn_settings(datapath, [])["PYTORCH"]
        s["PYTORCH"]["multi_element_option"] = 2
        custom = {"numTypes": 2, "type": "In P"}
        name = "InP_custom"
    else:
        s = nn_settings(datapath, groups)
        custom = {"numTypes": 1, "type": "Ta"}
        name = "Ta_custom"
    del s["BISPECTRUM"], s["PYTORCH"]["dgrad_mode"]
    s["CUSTOM"] = dict(custom, num_radial=8, num_3body=23, cutoff=5.0)
    s["CALCULATOR"] = {"calculator": "LAMMPSCUSTOM", "energy": 1, "force": 1,
                       "stress": 0, "nonlinear": 1}
    s["SOLVER"] = {"solver": "PYTORCH"}
    s["PYTORCH"]["output_file"] = f"{name}.pt"
    s["OUTFILE"] = {"metrics": f"{name}_metrics.md", "potential": name,
                    "output_style": "CUSTOM"}
    return s


def fe_settings(datapath, groups=None):
    """A SNAP model for `fe_configs`: the Ta_Linear_JCP2014 BISPECTRUM
    (twojmax 6, 30 descriptors) with type Fe and rcutfac 4.7, and a
    REFERENCE of `hybrid/overlay zero 10.0 zbl 4.0 4.8 coul/cut 5.0
    spin/exchange/biquadratic 4.5` (ZBL for Z = 26; Bethe-Slater exchange
    and biquadratic profiles with the offset, energy only), so the fit
    reads the set's `Spins` and `Charges`."""
    groups = FE_GROUPS if groups is None else groups
    table = {g: " ".join(str(v) for v in FE_GROUPS[g]) for g in groups}
    s = ta_settings(datapath, groups=[])
    s["BISPECTRUM"].update(type="Fe", rcutfac=4.7)
    s["ESHIFT"] = {"Fe": 0.0}
    s["REFERENCE"] = {
        "units": "metal", "atom_style": "spin",
        "pair_style": "hybrid/overlay zero 10.0 zbl 4.0 4.8 coul/cut 5.0 "
                      "spin/exchange/biquadratic 4.5",
        "pair_coeff1": "* * zero", "pair_coeff2": "* * zbl 26 26",
        "pair_coeff3": "* * coul/cut",
        "pair_coeff4": "* * spin/exchange/biquadratic biquadratic 4.5 "
                       "0.2827 -4.747 0.7810 0.0234 -1.0 0.6 offset yes"}
    s["OUTFILE"] = {"metrics": "Fe_metrics.md", "potential": "Fe_pot"}
    s["GROUPS"].update(table)
    return s


def inp_settings(datapath, groups=None):
    """Input sections of the InP_JPCA2020 example's explicit multi-element
    SNAP model for `datapath`: BISPECTRUM (two elements, twojmax 6,
    rcutfac 1.0, radelem 3.812 / 3.829, wj 1 / 0.9293, chemflag,
    wselfallflag, bnormflag, bzeroflag 1: 2 x 240 columns, 482
    coefficients), ESHIFT and the ZBL REFERENCE as the example sets them;
    the groups are `inp_configs`'."""
    groups = INP_GROUPS if groups is None else groups
    table = {g: " ".join(str(v) for v in INP_GROUPS[g]) for g in groups}
    s = ta_settings(datapath, groups=[])
    s["BISPECTRUM"] = {
        "numTypes": 2, "twojmax": "6 6", "rcutfac": 1.0, "rfac0": 0.99363,
        "rmin0": 0.0, "wj": "1.0 0.9293160905266721",
        "radelem": "3.812045629514403 3.829453817954964", "type": "In P",
        "wselfallflag": 1, "chemflag": 1, "bnormflag": 1, "bzeroflag": 1,
        "quadraticflag": 0}
    s["ESHIFT"] = {"In": -1.65967588701534, "P": 4.38159549501534}
    s["REFERENCE"] = {
        "units": "metal", "atom_style": "atomic",
        "pair_style": "hybrid/overlay zero 10.0 zbl 4.0 4.2",
        "pair_coeff1": "* * zero", "pair_coeff2": "1 1 zbl 49 49",
        "pair_coeff3": "1 2 zbl 49 15", "pair_coeff4": "2 2 zbl 15 15"}
    s["OUTFILE"] = {"metrics": "InP_metrics.md", "potential": "InP_pot"}
    s["GROUPS"].update(table)
    return s


def inp_nn_settings(datapath, groups=None, dgrad_mode="precompute"):
    """`inp_settings` for the NN solver: nonlinear 1 and the [PYTORCH]
    section of `nn_settings` (`dgrad_mode` as given), writing InP_nn.pt,
    InP_nn_metrics.md and InP_nn_pot.*."""
    s = inp_settings(datapath, groups)
    s["CALCULATOR"]["nonlinear"] = 1
    s["SOLVER"] = {"solver": "PYTORCH"}
    s["PYTORCH"] = dict(nn_settings(datapath, [], dgrad_mode)["PYTORCH"],
                        output_file="InP_nn.pt")
    s["OUTFILE"] = {"metrics": "InP_nn_metrics.md", "potential": "InP_nn_pot"}
    return s


def ace_settings(datapath, groups=None):
    """Input sections of a Ta_PACE-shaped ACE fit for `datapath`.

    The [ACE] section holds the Ta_PACE example's hyperparameters (ranks
    1-6, lmax 1 2 2 2 1 1, nmax 22 2 2 2 1 1, lmin 1, nmaxbase 22, rcutfac
    4.604694451, lambda 3.059235105; b_basis minsub, whose labels equal
    the example's shipped coupling table: 68 labels, 39 A-slots, 1,540
    product terms) with the section's default bzeroflag 0, so the constant
    column is on the path; the rest is `ta_settings`' (groups, ZBL 4.0-4.8 for
    Z = 73, energy/force/stress rows), with PACE output.
    """
    s = ta_settings(datapath, groups)
    del s["BISPECTRUM"]
    s["ACE"] = {"numTypes": 1, "type": "Ta", "ranks": "1 2 3 4 5 6",
                "lmax": "1 2 2 2 1 1", "nmax": "22 2 2 2 1 1", "lmin": 1,
                "nmaxbase": 22, "rcutfac": 4.604694451,
                "lambda": 3.059235105, "b_basis": "minsub"}
    s["CALCULATOR"]["calculator"] = "LAMMPSPACE"
    s["OUTFILE"]["output_style"] = "PACE"
    return s


def ace_nn_settings(datapath, groups=None, dgrad_mode="precompute"):
    """Nonlinear ACE (the reference's Ta_PACE_PyTorch_NN shape): the
    Ta_PACE [ACE] section of `ace_settings` (68 labels) under the NN
    solver, with the [PYTORCH] section of `nn_settings` (`num_desc 64 64
    1`, batch 4, 10 epochs, seed 13, `dgrad_mode` as given), writing
    Ta_ace_nn.pt, Ta_ace_nn_metrics.md and no potential (PACE output of a
    nonlinear fit writes none)."""
    s = ace_settings(datapath, groups)
    s["CALCULATOR"]["nonlinear"] = 1
    s["SOLVER"] = {"solver": "PYTORCH"}
    s["PYTORCH"] = dict(nn_settings(datapath, [], dgrad_mode)["PYTORCH"],
                        output_file="Ta_ace_nn.pt")
    s["OUTFILE"] = {"metrics": "Ta_ace_nn_metrics.md",
                    "potential": "Ta_ace_nn_pot", "output_style": "PACE"}
    return s


def pas_settings(datapath, base=ta_settings, groups=None):
    """A per-atom-scalar fit of the `Chis` of `with_chis` for `datapath`:
    `base` (`ta_settings`, `inp_settings` or `ace_settings`) with energy,
    force and stress 0, nonlinear 1 and per_atom_scalar 1, under the NN
    solver with the [PYTORCH] section of `nn_settings` (`num_desc 64 64 1`,
    batch 4, 10 epochs, seed 13), writing <name>_pas.pt,
    <name>_pas_metrics.md and <name>_pas_pot.* (name: Ta, InP or Ta_ace)."""
    name = {"ta_settings": "Ta", "inp_settings": "InP",
            "ace_settings": "Ta_ace"}[base.__name__] + "_pas"
    s = base(datapath, groups)
    s["CALCULATOR"].update(energy=0, force=0, stress=0, nonlinear=1,
                           per_atom_scalar=1)
    s["SOLVER"] = {"solver": "PYTORCH"}
    s["PYTORCH"] = dict(nn_settings(datapath, [])["PYTORCH"],
                        output_file=f"{name}.pt")
    del s["PYTORCH"]["dgrad_mode"]
    s["OUTFILE"] = dict(s["OUTFILE"], metrics=f"{name}_metrics.md",
                        potential=f"{name}_pot")
    return s


def write_ini(path, settings):
    """Write input sections as an INI file."""
    lines = []
    for sec, kv in settings.items():
        lines.append(f"[{sec}]")
        lines += [f"{k} = {v}" for k, v in kv.items()]
        lines.append("")
    Path(path).write_text("\n".join(lines))


def truths_from_rows(a, b0, beta, natoms):
    """Per-config (energy, forces, stress) whose rows equal a @ beta.

    a, b0: the rows and right-hand side of the configs computed with zero
    truths (b0 is minus the reference potential); natoms: atom counts in
    row order (energy, 3 n force, 6 stress rows per config).
    """
    t = a @ beta - b0
    out, row = [], 0
    for n in natoms:
        e = t[row] * n
        f = t[row + 1:row + 1 + 3 * n].reshape(n, 3)
        v = t[row + 1 + 3 * n:row + 7 + 3 * n]
        s = np.array([[v[0], v[5], v[4]], [v[5], v[1], v[3]],
                      [v[4], v[3], v[2]]])
        out.append((e, f, s))
        row += 7 + 3 * n
    return out
