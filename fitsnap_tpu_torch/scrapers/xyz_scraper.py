"""Extended-XYZ scraper (reference `fitsnap3lib/scrapers/xyz_scraper.py`).

Each group is one `<group>.xyz` / `<group>.extxyz` file of frames:
  natoms
  key=value header (Lattice="9 floats", Properties=species:S:1:pos:R:3:...,
                    energy=..., stress="9 floats", pbc="T T T")
  natoms atom lines per the Properties column spec.

Parity note: scraped output is ordered training-first then testing
(`xyz_scraper.py:496-499`).

Copy of `fitsnap_tpu/scrapers/xyz_scraper.py`.
"""

import re
from os import listdir, path

import numpy as np

from fitsnap_tpu_torch.scrapers.base import Scraper
from fitsnap_tpu_torch.utils.torchsetup import open_output

_KEY_VAL = re.compile(
    r"""(?P<key>[A-Za-z_][A-Za-z0-9_-]*)\s*=\s*"""
    r"""(?:"(?P<quoted>[^"]*)"|(?P<plain>\S+))""")


def parse_header(line):
    out = {}
    for m in _KEY_VAL.finditer(line):
        key = m.group("key")
        val = m.group("quoted") if m.group("quoted") is not None \
            else m.group("plain")
        out[key] = val
    return out


def parse_properties(spec):
    """'species:S:1:pos:R:3' -> list of (name, type, ncols)."""
    f = spec.split(":")
    return [(f[i], f[i + 1], int(f[i + 2])) for i in range(0, len(f), 3)]


def read_xyz_frames(fname, limit=None):
    """Standalone extended-XYZ frame reader (no config needed).

    Yields dicts with Lattice (rows = lattice vectors, ASE convention),
    Positions, AtomTypes, Energy, Forces — the fields `ase_scraper`'s
    Atoms duck-type needs.  Library-mode convenience mirroring
    `ase.io.read(path, ":")` for environments without `ase`
    (reference `examples/library/ase/example1.py` workflow).
    """
    count = 0
    with open(fname) as fp:
        while limit is None or count < limit:
            line = fp.readline()
            if not line.strip():
                return
            natoms = int(line)
            info = parse_header(fp.readline())
            spec = parse_properties(
                info.pop("Properties", "species:S:1:pos:R:3"))
            rows = [fp.readline().split() for _ in range(natoms)]
            arrays = {}
            col = 0
            for name, ptype, ncols in spec:
                vals = [r[col:col + ncols] for r in rows]
                arr = np.array(vals, float if ptype == "R"
                               else int if ptype == "I" else str)
                arrays[name] = arr[:, 0] if ncols == 1 else arr
                col += ncols
            forces = arrays.get("forces", arrays.get("force"))
            yield {
                "Lattice": np.array(info["Lattice"].split(),
                                    float).reshape(3, 3),
                "Positions": arrays["pos"],
                "AtomTypes": [s.capitalize() for s in arrays["species"]],
                "Energy": float(info["energy"]) if "energy" in info
                else None,
                "Forces": np.asarray(forces, float)
                if forces is not None else None,
            }
            count += 1


class XyzScraper(Scraper):
    def scrape_groups(self):
        self.files = {}
        self.configs = {}
        self.tests = {}
        groups = self.config.sections["GROUPS"]
        self.group_table = groups.group_table
        datapath = self.config.sections["PATH"].datapath
        contents = listdir(datapath)
        group_dict = {k: groups.group_types[i]
                      for i, k in enumerate(groups.group_sections)}
        if groups.random_sampling:
            import random
            random.seed(groups.random_seed or None)

        # frame-offset caching (reference xyz_scraper.py:288-376): indexing
        # a many-GB .xyz means reading every line once; save_group_scrape
        # writes the per-group byte offsets, read_group_scrape reuses them
        sc = self.config.sections["SCRAPER"]
        infile_dir = self.config.sections["PATH"].infile_directory
        save_file = read_file = None
        cached_offsets = {}
        if sc.save_group_scrape != "None" and sc.read_group_scrape != "None":
            raise RuntimeError(
                "Do not set both reading and writing of group_scrape")
        if sc.save_group_scrape != "None":
            save_file = path.join(infile_dir, sc.save_group_scrape)
            open_output(save_file).close()
        if sc.read_group_scrape != "None":
            read_file = path.join(infile_dir, sc.read_group_scrape)
            with open(read_file) as fp:
                for line in fp:
                    parts = line.split()
                    if parts:
                        cached_offsets[parts[0]] = [int(x)
                                                    for x in parts[1:]]

        for key, row in self.group_table.items():
            training_size = row.get("training_size", row.get("size"))
            size_type = group_dict.get(
                "training_size" if "training_size" in row else "size")
            testing_size = row.get("testing_size", 0)
            testing_size_type = group_dict.get("testing_size")
            if training_size is None:
                raise ValueError(f"Please set training size for {key}")
            fname = None
            for ext in (".extxyz", ".xyz"):
                if key + ext in contents:
                    fname = path.join(datapath, key + ext)
                    break
            if fname is None:
                raise FileNotFoundError(f"{key}.xyz not found in {datapath}")

            if key in cached_offsets:
                offsets = list(cached_offsets[key])
            else:
                # index frame byte offsets
                offsets = []
                with open(fname) as fp:
                    while True:
                        pos = fp.tell()
                        line = fp.readline()
                        if not line.strip():
                            break
                        n = int(line)
                        offsets.append(pos)
                        fp.readline()
                        for _ in range(n):
                            fp.readline()
            if save_file is not None:
                with open_output(save_file, "a") as fp:
                    fp.write(" ".join([key] + [str(o) for o in offsets])
                             + "\n")
            if groups.random_sampling:
                import random
                random.shuffle(offsets)
            nconfigs = len(offsets)
            if training_size < 1 or (training_size == 1
                                     and size_type == float):
                if training_size == 1:
                    training_size = training_size * nconfigs
                elif training_size != 0:
                    training_size = max(
                        1, int(abs(training_size) * nconfigs + 0.5))
                if "size" in row and testing_size == 0:
                    testing_size = nconfigs - training_size
            if testing_size != 0 and (
                    testing_size < 1
                    or (testing_size == 1 and testing_size_type == float)):
                testing_size = max(1, int(abs(testing_size) * nconfigs + 0.5))
            training_size = self._float_to_int(training_size)
            testing_size = self._float_to_int(testing_size)
            for _ in range(nconfigs - training_size - testing_size):
                offsets.pop()
            tests = [offsets.pop() for _ in range(testing_size)]
            self.files[key] = fname
            self.configs[key] = offsets
            self.tests[key] = tests
            row["training_size"] = training_size
            row["testing_size"] = testing_size

    def divvy_up_configs(self):
        flat = []
        self.test_bool = []
        for key in self.configs:
            for off in self.configs[key]:
                flat.append((key, off))
                self.test_bool.append(0)
        for key in self.tests:
            for off in self.tests[key]:
                flat.append((key, off))
                self.test_bool.append(1)
        self.configs = flat

    def scrape_configs(self):
        from copy import copy
        all_train, all_test = [], []
        props_cfg = self.config.sections["SCRAPER"].properties
        for i, (key, off) in enumerate(self.configs):
            self.conversions = copy(self.default_conversions)
            fname = self.files[key]
            with open(fname) as fp:
                fp.seek(off)
                natoms = int(fp.readline())
                info = parse_header(fp.readline())
                spec = parse_properties(
                    info.pop("Properties", "species:S:1:pos:R:3"))
                rows = [fp.readline().split() for _ in range(natoms)]
            arrays = {}
            col = 0
            for name, ptype, ncols in spec:
                vals = [r[col:col + ncols] for r in rows]
                if ptype == "R":
                    arr = np.array(vals, float)
                elif ptype == "I":
                    arr = np.array(vals, int)
                else:
                    arr = np.array(vals, str)
                arrays[name] = arr[:, 0] if ncols == 1 else arr
                col += ncols

            data = {}
            data["AtomTypes"] = [s.capitalize() for s in arrays["species"]]
            data["Positions"] = arrays["pos"]
            if "forces" in arrays:
                data["Forces"] = arrays["forces"]
            elif "force" in arrays:
                data["Forces"] = arrays["force"]
            lat = np.array(info["Lattice"].split(), float).reshape(3, 3)
            if "energy" in info:
                data["Energy"] = float(info["energy"])
            if "stress" in info:
                data["Stress"] = np.array(
                    info["stress"].split(), float).reshape(3, 3)
            elif "virial" in info:
                data["Stress"] = np.array(
                    info["virial"].split(), float).reshape(3, 3)
            data["NumAtoms"] = natoms
            data["Group"] = key
            data["File"] = fname.split("/")[-1]
            # extxyz Lattice rows are lattice vectors; QMLattice wants them
            # as columns (transpose validated against the Ta_XYZ
            # 19Nov19_Standard to 3e-13)
            data["QMLattice"] = (lat * self.conversions["Lattice"]).T
            eshift = self.config.sections["ESHIFT"].eshift
            if eshift:
                for atom in data["AtomTypes"]:
                    data["Energy"] += eshift.get(atom, 0.0)
            data["test_bool"] = self.test_bool[i]
            data["Energy"] *= self.conversions["Energy"]
            for k in ("Positions", "Forces", "Stress"):
                if k in data:
                    data[k] = np.asarray(data[k], float)

            self.data = data
            self._rotate_coords()
            self._translate_coords()
            self._weighting(natoms)
            (all_test if data["test_bool"] else all_train).append(self.data)
        return all_train + all_test
