"""FitSnap facade: scrape -> compute -> fit -> output, on torch devices.

Counterpart of `fitsnap_tpu/fitsnap.py` with the same factories and stage
methods: `FitSnap(input, arglist, device).scrape_configs()`,
`.process_configs()`, `.perform_fit()`, `.write_output()`.  The port takes
the JSON, XYZ and VASP scrapers, the LAMMPSSNAP, LAMMPSPACE and
LAMMPSCUSTOM calculators, every solver of the JAX package: the host ones
(SVD, RIDGE, LASSO, ARD, ANL, BCS, MCMC, OPT, MERR), the device ones
(TPUSVD / SCALAPACK, TENSORFLOWSVD) and the NN solver (PYTORCH / NETWORK
/ JAX) on LAMMPSSNAP descriptors in its cached, OTF and precompute modes,
on LAMMPSPACE descriptors (nonlinear ACE) in its OTF and precompute modes
and as the custom pairwise NN on LAMMPSCUSTOM, and SNAP, PACE and CUSTOM
output; any other choice raises NotImplementedError naming its ROADMAP
item by title.

Under a `torch.distributed` process group (`torchrun --nproc_per_node N -m
fitsnap_tpu_torch in.in`, or the caller's own group) every rank scrapes and
processes the whole set, the device solvers split their work over the
group, and rank 0 alone writes files and screen text.  `--devices N` must
then equal the group's size; N > 1 without a group raises.
"""

import random
import time

import torch

from fitsnap_tpu_torch.config import Config
from fitsnap_tpu_torch.utils.torchsetup import (from_rank_zero, make_group,
                                                rank_zero_first, save,
                                                setup_precision, working_type,
                                                writer)

_LATER = '{} {} is not ported to fitsnap_tpu_torch yet (ROADMAP.md: "{}")'


def _scraper_factory(config):
    name = config.sections["SCRAPER"].scraper.upper()
    if name == "JSON":
        from fitsnap_tpu_torch.scrapers.json_scraper import JsonScraper
        return JsonScraper(name, config)
    if name == "XYZ":
        from fitsnap_tpu_torch.scrapers.xyz_scraper import XyzScraper
        return XyzScraper(name, config)
    if name == "VASP":
        from fitsnap_tpu_torch.scrapers.vasp_scraper import VaspScraper
        return VaspScraper(name, config)
    raise NotImplementedError(f"scraper {name}")


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


_NN_SOLVERS = ("PYTORCH", "NETWORK", "JAX")
# the host solvers, numpy (and scipy or sklearn inside their methods)
_HOST_SOLVERS = {
    "SVD": "svd:SVD",
    "RIDGE": "linear:Ridge",
    "LASSO": "linear:Lasso",
    "ARD": "linear:ARD",
    "ANL": "linear:ANL",
    "BCS": "linear:BCS",
    "MCMC": "linear:MCMC",
    "OPT": "linear:OPT",
    "MERR": "merr:MERR",
}


def refuse_float32(config):
    """`--dtype float32` where the fit takes float32, else raise before
    anything is built: a linear solver names the two paths that take
    float32, the NN solver the ROADMAP.md queue item of its mode
    (`solvers/network.refuse_float32`)."""
    if working_type(config.args) != torch.float32:
        return
    name = config.sections["SOLVER"].solver.upper()
    if name in _NN_SOLVERS:
        from fitsnap_tpu_torch.solvers.network import refuse_float32 as nn
        return nn(config)
    raise TypeError(
        f"--dtype float32: solver {name} fits at float64.  float32 takes "
        "the NN solver's cached and OTF modes of linear SNAP networks "
        "(solver PYTORCH) and the streamed fit through its packers "
        "(parallel/fit.py pack_batch_pos(..., np.float32))")


def _solver_factory(config, device):
    name = config.sections["SOLVER"].solver.upper()
    if name in _HOST_SOLVERS:
        import importlib
        mod_name, cls_name = _HOST_SOLVERS[name].split(":")
        mod = importlib.import_module(f"fitsnap_tpu_torch.solvers.{mod_name}")
        return getattr(mod, cls_name)(name, config)
    if name == "TENSORFLOWSVD":
        from fitsnap_tpu_torch.solvers.svd import TfSVD
        return TfSVD(name, config, device)
    if name in ("TPUSVD", "SCALAPACK"):
        from fitsnap_tpu_torch.solvers.tpu_svd import TpuSVD
        return TpuSVD(name, config, device)
    if name in _NN_SOLVERS:
        from fitsnap_tpu_torch.solvers.network import NetworkSolver
        return NetworkSolver(name, config, device)
    raise NotImplementedError(f"solver {name}")


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


def check_devices(devices, size):
    """`--devices` against the size of the process group (1 without
    one)."""
    if devices is None or devices == size:
        return
    if size == 1 and devices > 1:
        raise ValueError(
            f"--devices {devices} needs {devices} processes, one a card, in "
            f"a torch.distributed group: run `torchrun --nproc_per_node "
            f"{devices} -m fitsnap_tpu_torch <input>`")
    raise ValueError(f"--devices {devices} does not match the process "
                     f"group's {size} processes")


class FitSnap:
    """One fit.  `device` is `cuda` unless the caller asks for `cpu`
    (here or with `--device cpu` in `arglist`); without a CUDA device the
    default raises.  Under a process group, `cuda` is `cuda:LOCAL_RANK`."""

    def __init__(self, input=None, arglist=None, device=None):
        setup_precision()
        self.config = Config(input, arglist or [])
        refuse_float32(self.config)
        self.group = make_group(
            device if device is not None else self.config.args.device)
        check_devices(self.config.args.devices, self.group.size)
        self.device = self.group.device
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
        groups = self.config.sections["GROUPS"]
        if self.group.size > 1 and groups.random_sampling \
                and not groups.random_seed:
            # the ranks sample alike: rank 0's draw seeds every rank
            groups.random_seed = from_rank_zero(random.random(),
                                                self.device)
        with rank_zero_first():
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
            save(outfile.descriptor_file, self.a)
        if extras.dump_b:
            save(outfile.truth_file, self.b)
        if extras.dump_w:
            save(outfile.weights_file, self.w)
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
        if writer():
            self.output.output(self.solver.fit, self.solver.errors)
        self.timings["output"] = time.time() - t0
