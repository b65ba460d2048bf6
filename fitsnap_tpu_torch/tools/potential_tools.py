"""Deployed-potential error checks (reference `tools/lammps_tools.py`).

The reference evaluates a fitted potential on a test directory by driving a
LAMMPS instance per configuration; here the same check runs through this
framework's own kernels — read the deployed `.snapcoeff` back, rebuild the
linear system for the test configs, and compare predictions to the truths.

    pt = PotentialTools("my_input.in", test_dir="test_JSON")
    errs = pt.calculate()        # {"energy_mae": ..., "force_mae": ...}

Copy of `fitsnap_tpu/tools/potential_tools.py` on the port's `FitSnap`,
which computes the rows on `device` (`cuda` unless the caller asks for
`cpu`).
"""

import os

import numpy as np


class PotentialTools:
    def __init__(self, input_script, test_dir=None, coeffs=None,
                 arglist=None, device=None):
        from fitsnap_tpu_torch.fitsnap import FitSnap

        self.fs = FitSnap(input_script,
                          arglist=list(arglist or []) + ["--overwrite"],
                          device=device)
        config = self.fs.config
        if test_dir is not None:
            config.sections["PATH"].datapath = test_dir
            groups = {key: {"training_size": 1.0, "testing_size": 0.0}
                      for key in os.listdir(test_dir)}
            config.sections["GROUPS"].group_table = groups
        self.fs.scrape_configs()
        self._coeffs = coeffs

    def coefficients(self):
        """Deployed coefficients: given explicitly, or read back from the
        written potential file (reference --nofit/only_test path)."""
        if self._coeffs is not None:
            return np.asarray(self._coeffs, float)
        return np.asarray(self.fs.output.read_fit(), float)

    @staticmethod
    def calc_mae(arr1, arr2):
        return float(np.mean(np.abs(np.asarray(arr1) - np.asarray(arr2))))

    def calculate(self):
        """Per-config predictions vs truths for the scraped test set."""
        self.fs.process_configs()
        a, b, w = self.fs.a, self.fs.b, self.fs.w
        fs_dict = self.fs.fs_dict
        coeffs = self.coefficients()
        width = a.shape[1]
        if coeffs.size != width:
            # .snapcoeff carries a leading offset row per type (bzeroflag)
            nt = self.fs.calculator.numtypes
            per = coeffs.size // nt
            coeffs = coeffs.reshape(nt, per)[:, 1:].reshape(-1)
        pred = a @ coeffs[:width]
        rt = np.asarray(fs_dict["Row_Type"])
        out = {}
        for name, key in (("energy", "Energy"), ("force", "Force"),
                          ("stress", "Stress")):
            m = rt == key
            if m.any():
                out[f"{name}_mae"] = self.calc_mae(pred[m], b[m])
                out[f"{name}_rmse"] = float(
                    np.sqrt(np.mean((pred[m] - b[m]) ** 2)))
        out["predictions"] = pred
        out["truths"] = b
        out["row_type"] = rt
        return out
