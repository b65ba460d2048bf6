"""FitSnap facade: scrape -> compute -> fit -> output, on one torch device.

Counterpart of `fitsnap_tpu/fitsnap.py` with the same factories and stage
methods: `FitSnap(input, arglist, device).scrape_configs()`,
`.process_configs()`, `.perform_fit()`, `.write_output()`.  The port takes
the JSON scraper, the LAMMPSSNAP, LAMMPSPACE and LAMMPSCUSTOM calculators,
the SVD, TPUSVD / SCALAPACK and TENSORFLOWSVD solvers, the NN solver
(PYTORCH / NETWORK / JAX) on LAMMPSSNAP descriptors in its cached, OTF and
precompute modes, on LAMMPSPACE descriptors (nonlinear ACE) in its OTF and
precompute modes and as the custom pairwise NN on LAMMPSCUSTOM, and SNAP,
PACE and CUSTOM output; any other choice raises NotImplementedError naming
its ROADMAP item by title.
"""

import time

import numpy as np

from fitsnap_tpu_torch.config import Config
from fitsnap_tpu_torch.utils.torchsetup import resolve_device, setup_precision

_LATER = '{} {} is not ported to fitsnap_tpu_torch yet (ROADMAP.md: "{}")'


def _scraper_factory(config):
    name = config.sections["SCRAPER"].scraper.upper()
    if name == "JSON":
        from fitsnap_tpu_torch.scrapers.json_scraper import JsonScraper
        return JsonScraper(name, config)
    raise NotImplementedError(_LATER.format(
        "scraper", name, "Host copies"))


def _calculator_factory(config, device):
    name = config.sections["CALCULATOR"].calculator.upper()
    if name == "LAMMPSSNAP":
        from fitsnap_tpu_torch.calculators.snap import SnapCalculator
        return SnapCalculator(name, config, device)
    if name == "LAMMPSPACE":
        from fitsnap_tpu_torch.calculators.ace import AceCalculator
        return AceCalculator(name, config, device)
    if name == "LAMMPSCUSTOM":
        from fitsnap_tpu_torch.calculators.custom import CustomCalculator
        return CustomCalculator(name, config)
    raise NotImplementedError(_LATER.format("calculator", name,
                                            "Modules to port"))


def _solver_factory(config, device):
    name = config.sections["SOLVER"].solver.upper()
    if name == "SVD":
        from fitsnap_tpu_torch.solvers.svd import SVD
        return SVD(name, config)
    if name == "TENSORFLOWSVD":
        from fitsnap_tpu_torch.solvers.svd import TfSVD
        return TfSVD(name, config, device)
    if name in ("TPUSVD", "SCALAPACK"):
        from fitsnap_tpu_torch.solvers.tpu_svd import TpuSVD
        return TpuSVD(name, config, device)
    if name in ("PYTORCH", "NETWORK", "JAX"):
        from fitsnap_tpu_torch.solvers.network import NetworkSolver
        return NetworkSolver(name, config, device)
    raise NotImplementedError(_LATER.format(
        "solver", name, "Host copies"))


def _output_factory(config):
    style = config.sections["OUTFILE"].output_style.upper()
    if style == "SNAP":
        from fitsnap_tpu_torch.io.outputs.snap_output import SnapOutput
        return SnapOutput(style, config)
    if style == "PACE":
        from fitsnap_tpu_torch.io.outputs.pace_output import PaceOutput
        return PaceOutput(style, config)
    if style == "CUSTOM":
        from fitsnap_tpu_torch.io.outputs.custom_output import CustomOutput
        return CustomOutput(style, config)
    raise NotImplementedError(_LATER.format("output style", style,
                                            "Modules to port"))


class FitSnap:
    """One fit.  `device` is `cuda` unless the caller asks for `cpu`
    (here or with `--device cpu` in `arglist`); without a CUDA device the
    default raises."""

    def __init__(self, input=None, arglist=None, device=None):
        setup_precision()
        self.config = Config(input, arglist or [])
        self.device = resolve_device(
            device if device is not None else self.config.args.device)
        from fitsnap_tpu_torch.io.screen import init_output
        init_output(self.config.args)
        self.scraper = _scraper_factory(self.config)
        self.calculator = _calculator_factory(self.config, self.device)
        self.solver = _solver_factory(self.config, self.device)
        self.output = _output_factory(self.config)
        self.data = None
        self.a = self.b = self.w = None
        self.fs_dict = None
        self.fit = None
        self.timings = {}

    # ---------------- pipeline stages ----------------

    def scrape_configs(self, delete_scraper: bool = False):
        t0 = time.time()
        self.scraper.scrape_groups()
        self.scraper.divvy_up_configs()
        self.data = self.scraper.scrape_configs()
        self.timings["scrape"] = time.time() - t0
        if delete_scraper:
            self.scraper = None
        return self.data

    def process_configs(self, data=None, delete_data: bool = False):
        t0 = time.time()
        data = data if data is not None else self.data
        if self.config.sections["CALCULATOR"].nonlinear:
            # NN path: per-atom descriptors and their pair jacobian stay on
            # the device; no A matrix is formed
            self.solver.prepare_dataset(self.calculator, data)
            self.timings["process"] = time.time() - t0
            if delete_data:
                self.data = None
            return
        self.a, self.b, self.w, self.fs_dict = \
            self.calculator.process_configs(data)
        self.timings["process"] = time.time() - t0
        extras = self.config.sections["EXTRAS"]
        outfile = self.config.sections["OUTFILE"]
        if extras.dump_a:
            np.save(outfile.descriptor_file, self.a)
        if extras.dump_b:
            np.save(outfile.truth_file, self.b)
        if extras.dump_w:
            np.save(outfile.weights_file, self.w)
        if delete_data:
            self.data = None

    def perform_fit(self):
        t0 = time.time()
        if not self.config.args.perform_fit:
            pass
        elif self.config.sections["EXTRAS"].only_test:
            self.fit = self.output.read_fit()
            self.solver.fit = self.fit
        elif self.config.sections["CALCULATOR"].nonlinear:
            self.solver.perform_fit(calculator=self.calculator,
                                    data=self.data)
        else:
            self.solver.perform_fit(self.a, self.b, self.w, self.fs_dict)
            self.fit = self.solver.fit
        self.solver.error_analysis(self.a, self.b, self.w, self.fs_dict)
        self.timings["fit"] = time.time() - t0

    def write_output(self):
        t0 = time.time()
        self.output.output(self.solver.fit, self.solver.errors)
        self.timings["output"] = time.time() - t0
