"""Generic output style (reference `io/outputs/custom.py`): coefficient
dump + metrics; for nonlinear fits just the metrics (the solver saves the
model state and its `.pt`).

Copy of `fitsnap_tpu/io/outputs/custom_output.py`; the metrics go through
the port's `SnapOutput.write_errors`."""

import numpy as np


class CustomOutput:
    def __init__(self, name, config):
        self.config = config
        self.name = name

    def output(self, coeffs, errors):
        pot = self.config.sections["OUTFILE"].potential_name
        if coeffs is not None and pot:
            np.save(pot + "_coeffs.npy", np.asarray(coeffs))
        self.write_errors(errors)

    def write_errors(self, errors):
        from fitsnap_tpu_torch.io.outputs.snap_output import SnapOutput
        SnapOutput.write_errors(self, errors)

    def read_fit(self):
        pot = self.config.sections["OUTFILE"].potential_name
        return np.load(pot + "_coeffs.npy")
