"""FitSNAP-format JSON scraper (reference `fitsnap3lib/scrapers/json_scraper.py`).

Files hold one configuration under Dataset->Data[0] with Positions/Lattice/
AtomTypes/Energy/Forces/Stress plus *Style unit keys; an optional non-'{'
first line is a comment.
"""

from copy import copy
from json import loads

import numpy as np

from fitsnap_tpu_torch.scrapers.base import Scraper
from fitsnap_tpu_torch.units import convert


class JsonScraper(Scraper):
    def scrape_groups(self):
        super().scrape_groups()
        self.configs = self.files

    def scrape_configs(self):
        all_data = []
        calc = self.config.sections["CALCULATOR"]
        for i, file_name in enumerate(self.configs):
            if not file_name.endswith(".json"):
                continue
            with open(file_name) as f:
                if f.readline()[0] == "{":
                    f.seek(0)
                self.data = loads(f.read())

            assert len(self.data) == 1, f"more than one dataset in {file_name}"
            self.data = self.data["Dataset"]
            assert len(self.data["Data"]) == 1, \
                f"more than one configuration in {file_name}"
            self.data["File"] = file_name.split("/")[-1]
            datapath = self.config.sections["PATH"].datapath
            self.data["Group"] = file_name.replace(datapath, "").replace(
                self.data["File"], "").replace("/", "")
            self.data.update(self.data.pop("Data")[0])

            self.conversions = copy(self.default_conversions)
            props = self.config.sections["SCRAPER"].properties
            for key in list(self.data):
                if "Style" in key:
                    prop = key.replace("Style", "")
                    if prop in self.conversions:
                        spec = list(props[prop])
                        spec[1] = self.data[key]
                        self.conversions[prop] = convert(spec)
            for key in props:
                if key in self.data:
                    self.data[key] = np.asarray(self.data[key])

            natoms = int(np.shape(self.data["Positions"])[0])
            self.data["NumAtoms"] = natoms
            self.data["QMLattice"] = (
                self.data["Lattice"] * self.conversions["Lattice"]).T
            del self.data["Lattice"]
            if "Label" in self.data:
                del self.data["Label"]

            self.data["Energy"] = float(self.data["Energy"])
            eshift = self.config.sections["ESHIFT"].eshift
            if eshift:
                for atom in self.data["AtomTypes"]:
                    self.data["Energy"] += eshift.get(atom, 0.0)
            self.data["test_bool"] = self.test_bool[i]
            self.data["Energy"] *= self.conversions["Energy"]

            self._rotate_coords()
            self._translate_coords()
            self._weighting(natoms)
            all_data.append(self.data)
        return all_data
