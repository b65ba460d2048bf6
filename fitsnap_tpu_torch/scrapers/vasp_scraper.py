"""VASP OUTCAR scraper (reference `fitsnap3lib/scrapers/vasp_scraper.py`).

Recursively walks each group directory for files named ``*OUTCAR`` (the
reference globs ``datapath/**/*OUTCAR``, vasp_scraper.py:42-46), parses
every ionic step (lattice, positions, forces, stress in kB, energy without
entropy — or TOTEN with ``vasp_use_TOTEN``), and emits the standard data
dicts.  Per-step behavior matches the reference:

- steps are delimited by the electronic-loop terminator lines ("aborting
  loop..."); a step whose terminator says "unconverged" is kept but its
  cached JSON is labeled with ``vasp_unconverged_label``
  (vasp_scraper.py:103, 248-254);
- steps missing coordinate/force or energy blocks raise unless
  ``vasp_ignore_incomplete`` (vasp_scraper.py:270-293);
- each parsed step is cached as a FitSNAP-format JSON under
  ``vasp_json_pathname/group/`` and re-read on later runs unless
  ``vasp_ignore_jsons`` (vasp_scraper.py:235-312, 556-567);
- TRAINSHIFT per-element energy shifts are applied at scrape time
  (vasp_scraper.py:412-416).

Copy of `fitsnap_tpu/scrapers/vasp_scraper.py`.
"""

import json
import os
import re
from glob import glob
from os import path

import numpy as np

from fitsnap_tpu_torch.scrapers.base import Scraper


class IncompleteStep(Exception):
    pass


def _parse_outcar(text, use_toten=False, ignore_incomplete=False,
                  filename="OUTCAR"):
    """Yield per-ionic-step dicts from one OUTCAR's contents.

    Each step dict carries a ``converged`` bool taken from the step's
    electronic-loop terminator line.
    """
    lines = text.splitlines()
    elements = []
    ions_per_type = []
    for ln in lines[:2000]:
        if "VRHFIN" in ln:
            elements.append(ln.split("=")[1].split(":")[0].strip())
        if "ions per type" in ln:
            ions_per_type = [int(x) for x in ln.split("=")[1].split()]
            break
    types = []
    for el, n in zip(elements, ions_per_type):
        types += [el] * n
    natoms = len(types)

    steps = []
    cur = {}
    converged = True
    i = 0
    nlines = len(lines)
    lattice = None
    stress = None
    while i < nlines:
        ln = lines[i]
        if "aborting loop" in ln:
            converged = "unconverged" not in ln
        elif "direct lattice vectors" in ln:
            lattice = np.array(
                [[float(x) for x in lines[i + 1 + k].split()[:3]]
                 for k in range(3)])
        elif "in kB" in ln and "Pressure" not in ln:
            vals = [float(x) for x in ln.split()[2:8]]
            # OUTCAR order: XX YY ZZ XY YZ ZX
            xx, yy, zz, xy, yz, zx = vals
            stress = np.array([[xx, xy, zx], [xy, yy, yz], [zx, yz, zz]])
        elif "TOTAL-FORCE (eV/Angst)" in ln:
            pos = np.zeros((natoms, 3))
            frc = np.zeros((natoms, 3))
            try:
                for k in range(natoms):
                    v = [float(x) for x in lines[i + 2 + k].split()]
                    pos[k] = v[:3]
                    frc[k] = v[3:6]
                cur = {"Positions": pos, "Forces": frc,
                       "Lattice": lattice, "Stress": stress}
            except (IndexError, ValueError):
                if not ignore_incomplete:
                    raise IncompleteStep(
                        f"incomplete coordinate/force block in {filename} "
                        f"near line {i} (set vasp_ignore_incomplete=True "
                        "to skip such steps)")
                cur = {}
        elif "FREE ENERGIE OF THE ION-ELECTRON SYSTEM" in ln:
            toten = float(lines[i + 2].split()[-2])
            e_wo = None
            for k in range(3, 7):
                if i + k < nlines and "energy(sigma->" in lines[i + k]:
                    e_wo = float(lines[i + k].split()[-1])
                    break
            if cur.get("Positions") is not None:
                cur["Energy"] = toten if use_toten else (
                    e_wo if e_wo is not None else toten)
                cur["AtomTypes"] = list(types)
                cur["NumAtoms"] = natoms
                cur["converged"] = converged
                steps.append(cur)
                cur = {}
            elif not ignore_incomplete:
                raise IncompleteStep(
                    f"energy block without coordinates in {filename} near "
                    f"line {i} (set vasp_ignore_incomplete=True to skip)")
        i += 1
    return steps


def _step_to_dataset(step, group, json_filename, use_toten):
    """FitSNAP-JSON Dataset dict for one ionic step (vasp_scraper.py:295-308)."""
    return {"Dataset": {
        "Group": group,
        "File": json_filename,
        "use_TOTEN": bool(use_toten),
        "EnergyStyle": "electronvolt",
        "StressStyle": "kB",
        "AtomTypeStyle": "chemicalsymbol",
        "PositionsStyle": "angstrom",
        "ForcesStyle": "electronvoltperangstrom",
        "LatticeStyle": "angstrom",
        "Data": [{
            "Positions": np.asarray(step["Positions"]).tolist(),
            "Forces": np.asarray(step["Forces"]).tolist(),
            "Lattice": np.asarray(step["Lattice"]).tolist(),
            "Stress": np.asarray(step["Stress"]).tolist(),
            "Energy": float(step["Energy"]),
            "AtomTypes": list(step["AtomTypes"]),
            "NumAtoms": int(step["NumAtoms"]),
        }],
    }}


def _dataset_to_step(config_dict):
    data = config_dict["Dataset"]["Data"][0]
    return {"Positions": np.asarray(data["Positions"], float),
            "Forces": np.asarray(data["Forces"], float),
            "Lattice": np.asarray(data["Lattice"], float),
            "Stress": np.asarray(data["Stress"], float),
            "Energy": float(data["Energy"]),
            "AtomTypes": list(data["AtomTypes"]),
            "NumAtoms": int(data["NumAtoms"])}


class VaspScraper(Scraper):
    def scrape_groups(self):
        self.files = {}
        self.tests = {}
        self.configs = {}
        groups = self.config.sections["GROUPS"]
        self.group_table = groups.group_table
        datapath = self.config.sections["PATH"].datapath
        use_toten = groups.vasp_use_TOTEN
        jsonpath = groups.vasp_json_pathname
        ignore_jsons = groups.vasp_ignore_jsons
        ignore_incomplete = groups.vasp_ignore_incomplete
        unconv_label = groups.vasp_unconverged_label

        for key, row in self.group_table.items():
            folder = path.join(datapath, key)
            if not path.isdir(folder):
                raise FileNotFoundError(
                    f"group folder not found for group '{key}': {folder}")
            outcars = sorted(
                f for f in glob(path.join(folder, "**", "*"), recursive=True)
                if f.endswith("OUTCAR") and path.isfile(f))
            if not outcars:
                raise FileNotFoundError(
                    f"no OUTCAR files found under group folder {folder}")
            step_list = []
            json_dir = path.join(jsonpath, key)
            for f in outcars:
                stem = path.relpath(f, datapath).replace(
                    os.sep, "_").replace("_OUTCAR", "")
                # Anchor to `<stem>_<step>[_<label>].json` and sort by step
                # number: a lexicographic sort puts 'stem_10' before
                # 'stem_2' (changing the train/test tail split between the
                # first run and cached runs), and an unanchored glob also
                # matches other OUTCARs whose stem extends this one.
                step_re = re.compile(
                    re.escape(stem) + r"_(\d+)" +
                    (f"(?:_{re.escape(unconv_label)})?" if unconv_label
                     else "") + r"\.json$")
                matches = [
                    (int(m.group(1)), m.group(0))
                    for m in (step_re.fullmatch(path.basename(p))
                              for p in glob(
                                  path.join(json_dir, f"{stem}_*.json")))
                    if m]
                # a step can have both 'stem_N.json' and
                # 'stem_N_<label>.json' on disk (a rerun changed the
                # convergence label without removing the old file); load
                # ONE per step, preferring the unlabeled (converged) parse
                by_step = {}
                for step, name in sorted(matches):
                    labeled = bool(unconv_label) and name.endswith(
                        f"_{unconv_label}.json")
                    if step not in by_step or (
                            not labeled and by_step[step][1]):
                        by_step[step] = (name, labeled)
                cached = [path.join(json_dir, by_step[s][0])
                          for s in sorted(by_step)]
                if cached and not ignore_jsons:
                    for cf in cached:
                        with open(cf) as fp:
                            step = _dataset_to_step(json.load(fp))
                        step["File"] = cf
                        step["Group"] = key
                        step_list.append(step)
                    continue
                with open(f, errors="ignore") as fp:
                    steps = _parse_outcar(fp.read(), use_toten,
                                          ignore_incomplete, filename=f)
                os.makedirs(json_dir, exist_ok=True)
                for n, step in enumerate(steps, start=1):
                    label = "" if step.pop("converged", True) else \
                        f"_{unconv_label}" if unconv_label else ""
                    jf = path.join(json_dir, f"{stem}_{n}{label}.json")
                    try:
                        with open(jf, "w") as fp:
                            json.dump(_step_to_dataset(
                                step, key, jf, use_toten), fp,
                                indent=2, sort_keys=True)
                    except OSError:
                        pass  # read-only tree: run without the cache
                    step["File"] = jf
                    step["Group"] = key
                    step_list.append(step)
            nconfigs = len(step_list)
            training_size = row.get("training_size", row.get("size", 1.0))
            testing_size = row.get("testing_size", 0)
            if training_size <= 1:
                training_size = max(1, int(training_size * nconfigs + 0.5)) \
                    if training_size not in (0, 1) else int(
                        training_size * nconfigs)
            if 0 < testing_size < 1:
                testing_size = max(1, int(testing_size * nconfigs + 0.5))
            training_size = int(training_size)
            testing_size = int(testing_size)
            self.configs[key] = step_list[:training_size]
            self.tests[key] = step_list[
                training_size:training_size + testing_size]
            row["training_size"] = training_size
            row["testing_size"] = testing_size

    def divvy_up_configs(self):
        flat = []
        self.test_bool = []
        for key in self.configs:
            for s in self.configs[key]:
                flat.append(s)
                self.test_bool.append(0)
        for key in self.tests:
            for s in self.tests[key]:
                flat.append(s)
                self.test_bool.append(1)
        self.configs = flat

    def scrape_configs(self):
        all_data = []
        for i, step in enumerate(self.configs):
            self.data = dict(step)
            natoms = self.data["NumAtoms"]
            self.data["QMLattice"] = (
                np.asarray(self.data["Lattice"], float)
                * self.conversions["Lattice"]).T
            # OUTCAR stress is in kB
            self.data["Stress"] = np.asarray(self.data["Stress"]) * 1000.0
            eshift = self.config.sections["ESHIFT"].eshift
            if eshift:
                for atom in self.data["AtomTypes"]:
                    self.data["Energy"] += eshift.get(atom, 0.0)
            # TRAINSHIFT: per-element dataset alignment shift, VASP-only
            # (reference vasp_scraper.py:412-416 adds n_ions(el)*shift(el)).
            if self.config.has_section("TRAINSHIFT"):
                trainshift = self.config.sections["TRAINSHIFT"].trainshift
                for atom in self.data["AtomTypes"]:
                    self.data["Energy"] += trainshift.get(atom, 0.0)
            self.data["test_bool"] = self.test_bool[i]
            self.data["Energy"] = float(self.data["Energy"]) \
                * self.conversions["Energy"]
            self.data["Positions"] = np.asarray(self.data["Positions"], float)
            self.data["Forces"] = np.asarray(self.data["Forces"], float)
            self._rotate_coords()
            self._translate_coords()
            self._weighting(natoms)
            all_data.append(self.data)
        return all_data
