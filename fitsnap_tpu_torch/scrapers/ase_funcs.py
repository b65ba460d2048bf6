"""Library-mode ASE scraping (reference `fitsnap3lib/scrapers/ase_funcs.py`).

`ase_scraper(frames, energies=None, forces=None, stresses=None)` turns a
list of ASE Atoms into the data dicts the calculators consume, applying the
same cell normalization as the file scrapers.

Copy of `fitsnap_tpu/scrapers/ase_funcs.py`: it needs no `ase`, only
objects with the Atoms methods it calls.
"""

import numpy as np


def get_apre(cell):
    """LAMMPS-normal upper-triangular cell from a general 3x3 cell
    (rows = lattice vectors), reference `ase_funcs.py:41`."""
    a, b, c = cell
    an, bn, cn = (np.linalg.norm(v) for v in cell)
    alpha = np.arccos(np.dot(b, c) / (bn * cn))
    beta = np.arccos(np.dot(a, c) / (an * cn))
    gamma = np.arccos(np.dot(a, b) / (an * bn))
    xhi = an
    xyp = np.cos(gamma) * bn
    yhi = np.sin(gamma) * bn
    xzp = np.cos(beta) * cn
    yzp = (bn * cn * np.cos(alpha) - xyp * xzp) / yhi
    zhi = np.sqrt(cn ** 2 - xzp ** 2 - yzp ** 2)
    return np.array([[xhi, 0, 0], [xyp, yhi, 0], [xzp, yzp, zhi]])


def collate_data(atoms, name=None, group_dict=None):
    """One ASE Atoms -> FitSNAP data dict (reference `ase_funcs.py:66`)."""
    cell = np.asarray(atoms.cell)
    apre = get_apre(cell)
    R = np.dot(np.linalg.inv(cell), apre)
    positions = np.matmul(np.array(atoms.get_positions()), R)
    cell = apre.T

    data = {}
    data["PositionsStyle"] = "angstrom"
    data["AtomTypeStyle"] = "chemicalsymbol"
    data["StressStyle"] = "bar"
    data["LatticeStyle"] = "angstrom"
    data["EnergyStyle"] = "electronvolt"
    data["ForcesStyle"] = "electronvoltperangstrom"
    data["Group"] = name or "ASE"
    data["File"] = None
    data["Positions"] = positions
    data["AtomTypes"] = atoms.get_chemical_symbols()
    data["NumAtoms"] = len(atoms)
    data["QMLattice"] = cell
    data["Lattice"] = cell
    try:
        data["Energy"] = float(atoms.get_potential_energy())
    except Exception:
        data["Energy"] = float(atoms.info.get("energy", 0.0))
    try:
        data["Forces"] = np.array(atoms.get_forces()) @ R
    except Exception:
        data["Forces"] = np.zeros_like(positions)
    try:
        s = atoms.get_stress(voigt=False)
        data["Stress"] = R.T @ (np.asarray(s) * -1e-1 * 1e4) @ R  # GPa->bar
    except Exception:
        data["Stress"] = np.zeros((3, 3))
    data["test_bool"] = 0
    if group_dict:
        for k, v in group_dict.items():
            if "weight" in k:
                data[k] = v
    else:
        data["eweight"] = data["fweight"] = data["vweight"] = 1.0
    data["Rotation"] = R.T
    data["Translation"] = np.zeros_like(positions)
    return data


def ase_scraper(frames, name=None, group_dict=None):
    """List of ASE Atoms -> list of data dicts (reference `ase_funcs.py:10`)."""
    return [collate_data(a, name=name, group_dict=group_dict)
            for a in frames]
