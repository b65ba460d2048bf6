"""Scraper base: group file-walk, train/test split, coordinate normalization.

Behavioral parity with reference `fitsnap3lib/scrapers/scrape.py`:
  - group table sizes interpreted as fractions or counts (`scrape_groups`)
  - QR rotation of cells into LAMMPS-normal upper-triangular form with
    lattice vectors as columns (`_rotate_coords`, scrape.py:244)
  - PBC wrap of positions into the cell (`_translate_coords`, scrape.py:286)
  - group / Boltzmann / smart weighting (`_weighting`, scrape.py:323)

File lists are sorted for determinism (the reference uses raw listdir order,
which is filesystem-dependent; fitted coefficients are invariant to order).
"""

import random
from os import listdir, path, stat

import numpy as np

from fitsnap_tpu_torch.units import convert

# shared identity rotation for the already-normalized fast path (read-only)
_EYE3 = np.eye(3)
_EYE3.setflags(write=False)


class Scraper:
    def __init__(self, name, config):
        self.config = config
        self.name = name
        self.group_table = {}
        self.files = {}
        self.tests = None
        self.configs = {}
        self.test_bool = None
        self.data = {}
        self.default_conversions = {
            key: convert(spec)
            for key, spec in config.sections["SCRAPER"].properties.items()}
        self.conversions = dict(self.default_conversions)
        units = config.sections["REFERENCE"].units
        self.kb = {"real": 0.00198198665029335,
                   "metal": 0.00008617333262145}.get(units, 0.00008617333262145)

    def scrape_groups(self):
        self.files = {}
        self.tests = {}
        groups = self.config.sections["GROUPS"]
        self.group_table = groups.group_table
        group_dict = {k: groups.group_types[i]
                      for i, k in enumerate(groups.group_sections)}
        if groups.random_sampling:
            seed = groups.random_seed or random.random()
            random.seed(seed)

        for key, row in self.group_table.items():
            training_size = None
            size_type = None
            bc_bool = False
            if "size" in row:
                training_size = row["size"]
                bc_bool = True
                size_type = group_dict.get("size")
            if "training_size" in row:
                if training_size is not None:
                    raise ValueError("Do not set both size and training size")
                training_size = row["training_size"]
                size_type = group_dict.get("training_size")
            testing_size = row.get("testing_size", 0)
            testing_size_type = group_dict.get("testing_size")
            if training_size is None:
                raise ValueError(f"Please set training size for {key}")

            folder = path.join(self.config.sections["PATH"].datapath, key)
            folder_files = sorted(
                f for f in listdir(folder) if path.isfile(path.join(folder, f)))
            self.files[folder] = [path.join(folder, f) for f in folder_files]
            if groups.random_sampling:
                random.shuffle(self.files[folder])
            nfiles = len(folder_files)

            if training_size < 1 or (training_size == 1 and size_type == float):
                if training_size == 1:
                    training_size = abs(training_size) * nfiles
                elif training_size == 0:
                    pass
                else:
                    training_size = max(1, int(abs(training_size) * nfiles + 0.5))
                if bc_bool and testing_size == 0:
                    testing_size = nfiles - training_size
            if testing_size != 0 and (
                    testing_size < 1
                    or (testing_size == 1 and testing_size_type == float)):
                testing_size = max(1, int(abs(testing_size) * nfiles + 0.5))
            training_size = self._float_to_int(training_size)
            testing_size = self._float_to_int(testing_size)
            if nfiles - testing_size - training_size < 0:
                testing_size = nfiles - training_size

            self.tests[folder] = []
            for _ in range(nfiles - training_size - testing_size):
                self.files[folder].pop()
            for _ in range(testing_size):
                self.tests[folder].append(self.files[folder].pop())
            row["training_size"] = training_size
            row["testing_size"] = testing_size

    def divvy_up_configs(self):
        """Flatten group dict into an ordered config list + test flags."""
        self.test_bool = []
        flat = []
        for folder in self.configs:
            for c in self.configs[folder]:
                flat.append(c if not isinstance(c, list) else c[0])
                self.test_bool.append(0)
        if self.tests is not None:
            for folder in self.tests:
                for c in self.tests[folder]:
                    flat.append(c if not isinstance(c, list) else c[0])
                    self.test_bool.append(1)
        self.configs = flat

    @staticmethod
    def _float_to_int(x):
        if x == 0:
            return int(x)
        if x / int(x) != 1:
            raise ValueError("Training and testing size must be integers")
        return int(x)

    def _rotate_coords(self):
        """Rotate the cell into LAMMPS orientation (upper-triangular, +diag).

        Behavior-parity with the reference's per-config cell normalization
        (`fitsnap3lib/scrapers/scrape.py:244`), reimplemented in direct 3x3
        arithmetic: QR/assert machinery on 25k tiny matrices dominated the
        whole scrape.  Datasets that already store a LAMMPS-oriented cell
        (the common case) take the identity fast path.
        """
        in_cell = np.asarray(self.data["QMLattice"], np.float64)
        c = in_cell
        det = (c[0, 0] * (c[1, 1] * c[2, 2] - c[1, 2] * c[2, 1])
               - c[0, 1] * (c[1, 0] * c[2, 2] - c[1, 2] * c[2, 0])
               + c[0, 2] * (c[1, 0] * c[2, 1] - c[1, 1] * c[2, 0]))
        if det <= 0:
            raise ValueError(
                f"{self.data.get('File', '?')}: input cell is not "
                "right-handed (det <= 0)")
        pconv = self.conversions["Positions"]
        already = (c[1, 0] == 0.0 and c[2, 0] == 0.0 and c[2, 1] == 0.0
                   and c[0, 0] > 0 and c[1, 1] > 0 and c[2, 2] > 0)
        if already:
            rot = _EYE3
            out_cell = in_cell
            self.data["Positions"] = np.asarray(
                self.data["Positions"], np.float64) * pconv
            if self.config.sections["CALCULATOR"].force:
                self.data["Forces"] = np.asarray(
                    self.data["Forces"], np.float64) \
                    * self.conversions["Forces"]
            if self.config.sections["CALCULATOR"].stress:
                self.data["Stress"] = np.asarray(
                    self.data["Stress"], np.float64) \
                    * self.conversions["Stress"]
        else:
            qmat, rmat = np.linalg.qr(in_cell)
            rot = np.sign(np.diag(rmat))[:, None] * qmat.T
            out_cell = rot @ in_cell
            if max(abs(out_cell[1, 0]), abs(out_cell[2, 0]),
                   abs(out_cell[2, 1])) > 1e-10 * abs(out_cell).max():
                raise ValueError(
                    f"{self.data.get('File', '?')}: cell could not be "
                    "rotated upper-triangular (singular lattice?)")
            self.data["Positions"] = (np.asarray(
                self.data["Positions"], np.float64) * pconv) @ rot.T
            if self.config.sections["CALCULATOR"].force:
                self.data["Forces"] = (np.asarray(
                    self.data["Forces"], np.float64)
                    * self.conversions["Forces"]) @ rot.T
            if self.config.sections["CALCULATOR"].stress:
                self.data["Stress"] = rot @ (np.asarray(
                    self.data["Stress"], np.float64)
                    * self.conversions["Stress"]) @ rot.T
        self.data["Lattice"] = out_cell
        self.data["Rotation"] = rot

    def _translate_coords(self):
        """Wrap positions into the home cell (reference scrape.py:286)."""
        cell = self.data["Lattice"]
        pos = self.data["Positions"]
        # cell is upper-triangular by construction (_rotate_coords):
        # closed-form inverse beats np.linalg.inv on 25k tiny matrices
        a, b_, c_ = cell[0, 0], cell[0, 1], cell[0, 2]
        d, e = cell[1, 1], cell[1, 2]
        f = cell[2, 2]
        invcell = np.array([
            [1.0 / a, -b_ / (a * d), (b_ * e - c_ * d) / (a * d * f)],
            [0.0, 1.0 / d, -e / (d * f)],
            [0.0, 0.0, 1.0 / f]])
        frac = pos @ invcell.T
        # snap -1e-15-ish fractional coords to 0 so floor() keeps atoms on
        # the cell boundary in the home image (matches the reference's
        # isclose(frac, 0, atol=1e-15) epsilon)
        frac[np.abs(frac) <= 1e-15] = 0.0
        trans = np.floor(frac)
        if not trans.any():
            self.data["Translation"] = np.zeros_like(pos, dtype=float)
            return
        cfrac = frac - trans
        if ((cfrac < 0) | (cfrac >= 1)).any():
            raise ValueError("fractional coords outside cell after wrap")
        self.data["Positions"] = cfrac @ cell.T
        self.data["Translation"] = trans @ cell.T

    def _weighting(self, natoms):
        groups = self.config.sections["GROUPS"]
        table_row = self.group_table[self.data["Group"]]
        if groups.boltz == 0:
            for key in table_row:
                if "weight" in key:
                    self.data[key] = table_row[key]
        else:
            self.data["eweight"] = np.exp(
                (table_row["eweight"] - self.data["Energy"] / float(natoms))
                / (self.kb * float(groups.boltz)))
            for key in table_row:
                if "weight" in key and key != "eweight":
                    self.data[key] = self.data["eweight"] * table_row[key]
        if groups.smartweights:
            for key in table_row:
                if "weight" in key:
                    denom = (table_row["testing_size"] if self.data["test_bool"]
                             else table_row["training_size"])
                    self.data[key] = self.data[key] / denom if denom else 0
            if self.config.sections["CALCULATOR"].force:
                self.data["fweight"] /= natoms * 3
            if self.config.sections["CALCULATOR"].stress:
                self.data["vweight"] /= 6
