"""Input configuration: INI file or nested dict -> typed section objects.

Input-compatible with the reference's config system
(`fitsnap3lib/io/input.py`, `fitsnap3lib/io/sections/`): same section names,
keys, defaults and derived attributes, so shipped example inputs run
unchanged.  The implementation is a fresh, compact design (no section
factory / class registry): each section is a plain class that pulls typed
values out of a shared parser.
"""

import argparse
import configparser
import hashlib
import random
import time
from os import path, sysconf
from pathlib import Path


def strtobool(val) -> int:
    v = str(val).lower()
    if v in ("y", "yes", "t", "true", "on", "1"):
        return 1
    if v in ("n", "no", "f", "false", "off", "0"):
        return 0
    raise ValueError(f"invalid truth value {val!r}")


_CONVERTERS = {
    "str": str, "string": str,
    "bool": strtobool,
    "float": float,
    "int": int, "integer": int,
}


def parse_cmdline(arglist=None):
    parser = argparse.ArgumentParser(prog="fitsnap_tpu_torch")
    parser.add_argument("infile", action="store", nargs="?", default=None,
                        help="path to FitSNAP input script")
    parser.add_argument("--verbose", "-v", action="store_true", default=False)
    parser.add_argument("--lammpslog", "-l", action="store_true", default=False)
    parser.add_argument("--printlammps", "-pl", action="store_true",
                        default=False)
    parser.add_argument("--lammps_noexceptions", action="store_true",
                        default=False)
    parser.add_argument("--nofit", "-nf", dest="perform_fit",
                        action="store_false", default=True,
                        help="compute descriptors only, no fit")
    parser.add_argument("--overwrite", action="store_true", default=None)
    parser.add_argument("--relative", action="store_true", default=False)
    parser.add_argument("--tarball", "-tb", action="store_true", default=False)
    parser.add_argument("--keyword", "-k", nargs=3, metavar=("GROUP", "NAME", "VALUE"),
                        dest="keyword_replacements", action="append", default=[])
    # matches the reference's actual behavior (io/input.py store_false on
    # dest screen): passing --screen SILENCES per-rank screen output —
    # their docs say the opposite, but scripts target the code
    parser.add_argument("--screen", "-sc", action="store_false",
                        default=True, dest="screen")
    parser.add_argument("--nscreen", action="store_true", default=False)
    parser.add_argument("--pscreen", action="store_true", default=False)
    parser.add_argument("--log", default=None)
    parser.add_argument("--screen2file", default=None)
    parser.add_argument("--dtype", default=None,
                        help="compute dtype override: float32|float64")
    parser.add_argument("--device", choices=("cuda", "cpu"), default=None,
                        help="device to compute on (default cuda; cpu only "
                             "when asked for)")
    parser.add_argument("--devices", type=int, default=None,
                        help="processes to split the device work over: the "
                             "size of the torch.distributed group "
                             "(torchrun --nproc_per_node N); default the "
                             "group's size")
    parser.add_argument("--torchprof", default=None, metavar="DIR",
                        help="capture a torch.profiler trace of the run "
                             "(CUDA activity on the card) into DIR as a "
                             "Chrome trace (chrome://tracing, Perfetto)")
    return parser.parse_args(arglist if arglist else None)


class _Reader:
    """Typed access over a case-preserving ConfigParser.

    Every `get` records the (section, key) it consumed; `validate` then
    rejects any key present in the input that no section ever read — the
    unmatched-variable check of the reference
    (`fitsnap3lib/io/sections/sections.py:44-50`), derived from actual
    reads instead of hand-maintained allowed-key lists.
    """

    def __init__(self, cp: configparser.ConfigParser):
        self._cp = cp
        self._consumed = {}

    def _mark(self, section, key):
        self._consumed.setdefault(section, set()).add(key)

    def has_section(self, name):
        return self._cp.has_section(name)

    def get(self, section, key, fallback, interp="str"):
        self._mark(section, key)
        conv = _CONVERTERS[interp]
        if section not in self._cp:
            return conv(fallback)
        return conv(self._cp.get(section, key, fallback=fallback))

    def items(self, section):
        """Section-local (key, value) pairs.  [DEFAULT] keys leak into every
        configparser section proxy; dynamic-key sections (GROUPS group
        names, REFERENCE pair_coeff lines) must not see them."""
        if section not in self._cp:
            return []
        d = self._cp.defaults()
        return [(k, v) for k, v in self._cp.items(section) if k not in d]

    def keys(self, section):
        if section not in self._cp:
            return []
        d = self._cp.defaults()
        return [k for k in self._cp[section] if k not in d]

    def consume(self, section, key):
        """Mark a dynamically-named key (group name, pair_coeff*) as valid."""
        self._mark(section, key)

    def consume_all(self, section):
        for k in self.keys(section):
            self._mark(section, k)

    def validate(self, known_sections):
        for sec in self._cp.sections():
            if sec not in known_sections:
                raise ValueError(
                    f"Unknown section [{sec}] in input; known sections: "
                    f"{sorted(known_sections)}")
            used = self._consumed.get(sec, set())
            # configparser exposes [DEFAULT] keys through every section
            # proxy; they are not section-local variables
            defaults = set(self._cp.defaults())
            for key in self._cp[sec]:
                if key not in used and key not in defaults:
                    raise ValueError(
                        f"Found unmatched variable in {sec} section "
                        f"of input: {key}")


class BispectrumSection:
    name = "BISPECTRUM"

    def __init__(self, r: _Reader):
        self.numtypes = r.get(self.name, "numTypes", "1", "int")
        self.twojmax = r.get(self.name, "twojmax", "6").split()
        self.rcutfac = r.get(self.name, "rcutfac", "4.67637", "float")
        self.rfac0 = r.get(self.name, "rfac0", "0.99363", "float")
        self.rmin0 = r.get(self.name, "rmin0", "0.0", "float")
        self.wj = r.get(self.name, "wj", "1.0").split()
        self.radelem = r.get(self.name, "radelem", "0.5").split()
        self.types = r.get(self.name, "type", "H").split()
        self.type_mapping = {t: i + 1 for i, t in enumerate(self.types)}
        self.chemflag = r.get(self.name, "chemflag", "0", "bool")
        self.bnormflag = r.get(self.name, "bnormflag", "0", "bool")
        self.wselfallflag = r.get(self.name, "wselfallflag", "0", "bool")
        self.bzeroflag = r.get(self.name, "bzeroflag", "0", "bool")
        self.quadraticflag = r.get(self.name, "quadraticflag", "0", "bool")
        self.bikflag = r.get(self.name, "bikflag", "0", "bool")
        self.switchinnerflag = r.get(self.name, "switchinnerflag", "0", "bool")
        if self.switchinnerflag:
            self.sinner = r.get(self.name, "sinner",
                                (self.numtypes * "0.9 ").strip())
            self.dinner = r.get(self.name, "dinner",
                                (self.numtypes * "0.1 ").strip())
            if (len(self.sinner.split()) != self.numtypes
                    or len(self.dinner.split()) != self.numtypes):
                raise ValueError(
                    "Number of sinner/dinner args must be number of types.")
        else:
            self.sinner = self.dinner = None
        self.switchflag = r.get(self.name, "switchflag", "1", "bool")
        self.dgradflag = r.get(self.name, "dgradflag", "0", "bool")
        self._generate_b_list()

    def _generate_b_list(self):
        """blist / blank2J / ncoeff, matching reference `bispectrum.py:69`."""
        from itertools import combinations_with_replacement
        import numpy as np

        self.blist = []
        blank = []
        tjmax = int(max(self.twojmax))
        for atype in range(self.numtypes):
            i = 0
            for j1 in range(tjmax + 1):
                for j2 in range(j1 + 1):
                    for j in range(abs(j1 - j2), min(tjmax, j1 + j2) + 1, 2):
                        if j >= j1:
                            prefac = 1.0 if all(
                                ind <= int(self.twojmax[atype])
                                for ind in (j1, j2, j)) else 0.0
                            i += 1
                            self.blist.append([i, j1, j2, j])
                            blank.append(prefac)
        if self.chemflag:
            if int(min(self.twojmax)) != int(max(self.twojmax)):
                raise RuntimeError(
                    "Mixed per-element 2J with chemflag not supported.")
            self.blist = self.blist * self.numtypes ** 3
            blank = blank * self.numtypes ** 3
        if self.quadraticflag:
            # quadratic combinations over the full (possibly chem-extended)
            # per-type descriptor segment; the quad prefac is the product of
            # the factors' prefacs.  (The reference extends blank2J with the
            # base-width combinations BEFORE the chem replication,
            # `bispectrum.py:92-116`, which makes its blist/blank2J lengths
            # inconsistent when both flags are set — its final reshape
            # crashes, so this combination defines, rather than matches, the
            # file layout.)
            per_type = len(self.blist) // self.numtypes
            new, newb = [], []
            for atype in range(self.numtypes):
                seg = self.blist[per_type * atype: per_type * (atype + 1)]
                segb = blank[per_type * atype: per_type * (atype + 1)]
                new += seg
                newb += segb
                new += [[i, a, b] for i, (a, b) in enumerate(
                    combinations_with_replacement(seg, r=2), start=len(seg))]
                newb += [pa * pb for pa, pb in
                         combinations_with_replacement(segb, r=2)]
            self.blist = new
            blank = newb
        self.ncoeff = len(self.blist) // self.numtypes
        blank = np.asarray(blank, dtype=float)
        if not self.bzeroflag:
            blank = blank.reshape(self.numtypes, -1)
            blank = np.concatenate(
                [np.ones((self.numtypes, 1)), blank], axis=1).reshape(-1)
        self.blank2J = blank


class AceSection:
    """ACE hyperparameter section (descriptor table generation happens in
    `fitsnap_tpu_torch.ops.ace_couple` at calculator setup)."""

    name = "ACE"

    def __init__(self, r: _Reader):
        self.numtypes = r.get(self.name, "numTypes", "1", "int")
        self.types = r.get(self.name, "type", "H").split()
        self.type_mapping = {t: i + 1 for i, t in enumerate(self.types)}
        self.ranks = [int(x) for x in r.get(self.name, "ranks", "1 2 3").split()]
        self.lmax = [int(x) for x in r.get(self.name, "lmax", "0 2 2").split()]
        self.nmax = [int(x) for x in r.get(self.name, "nmax", "2 2 2").split()]
        self.nmaxbase = r.get(self.name, "nmaxbase", "16", "int")
        self.rcutfac = [float(x) for x in r.get(self.name, "rcutfac", "4.5").split()]
        self.lmbda = [float(x) for x in r.get(self.name, "lambda", "3.0").split()]
        self.rcinner = [float(x) for x in r.get(self.name, "rcinner", "0.0").split()]
        self.drcinner = [float(x) for x in r.get(self.name, "drcinner", "0.01").split()]
        self.lmin = [int(x) for x in r.get(self.name, "lmin", "0").split()]
        # a single lmin applies to every rank (reference ace.py:83-84)
        if len(self.lmin) == 1:
            self.lmin = self.lmin * len(self.ranks)
        # reference default is 0 (ace.py:48): a constant-offset column is
        # prepended unless the input turns it off
        self.bzeroflag = r.get(self.name, "bzeroflag", "0", "bool")
        # basis choice (reference ace.py:43): pa_tabulated (PA-RPI, the
        # reference default) or minsub (YSG); 'native' is this framework's
        # own left-fold basis
        self.b_basis = r.get(self.name, "b_basis", "pa_tabulated")
        self.wigner_flag = r.get(self.name, "wigner_flag", "1", "bool")
        # accepted-for-compatibility keys (reference ace.py:19-21): mumax is
        # always len(types) (ace.py:38), RPI_heuristic is unused there too
        r.get(self.name, "mumax", str(self.numtypes))
        r.get(self.name, "RPI_heuristic", "root_SO3_span")
        self.manuallabs = r.get(self.name, "manuallabs", "None")
        if self.manuallabs != "None":
            raise NotImplementedError(
                "ACE manuallabs label files are not supported; use "
                "b_basis = pa_tabulated | minsub | native")
        self.erefs = [float(x) for x in r.get(self.name, "erefs", " ".join(["0.0"] * self.numtypes)).split()]
        self.bikflag = r.get(self.name, "bikflag", "0", "bool")
        self.dgradflag = r.get(self.name, "dgradflag", "0", "bool")
        self.ncoeff = None   # set by the ACE calculator once labels are built
        self.blist = None
        self.blank2J = None


class CustomSection:
    """CUSTOM pairwise-descriptor calculator settings
    (reference `io/sections/calculator_sections/custom.py`)."""

    name = "CUSTOM"

    def __init__(self, r: _Reader):
        self.numtypes = r.get(self.name, "numTypes", "1", "int")
        self.types = r.get(self.name, "type", "H").split()
        self.type_mapping = {t: i + 1 for i, t in enumerate(self.types)}
        self.num_radial = r.get(self.name, "num_radial", "8", "int")
        self.num_3body = r.get(self.name, "num_3body", "23", "int")
        self.cutoff = r.get(self.name, "cutoff", "5.0", "float")
        # accepted-for-compatibility (reference custom.py:10,18): derived
        # quantities here, not free parameters
        r.get(self.name, "numAtoms", "1", "int")
        r.get(self.name, "num_descriptors", "0", "int")
        self.num_descriptors = self.num_radial + self.num_3body
        self.ncoeff = self.num_descriptors
        self.bzeroflag = True
        self.blist = []
        self.blank2J = None


class CalculatorSection:
    name = "CALCULATOR"

    def __init__(self, r: _Reader):
        self.calculator = r.get(self.name, "calculator", "LAMMPSSNAP")
        self.energy = r.get(self.name, "energy", "True", "bool")
        self.per_atom_energy = r.get(self.name, "per_atom_energy", "False", "bool")
        self.per_atom_scalar = r.get(self.name, "per_atom_scalar", "False", "bool")
        self.force = r.get(self.name, "force", "True", "bool")
        self.stress = r.get(self.name, "stress", "True", "bool")
        self.nonlinear = r.get(self.name, "nonlinear", "False", "bool")
        self.linear = not self.nonlinear
        # reference calculator.py:42-45: PAS excludes energies/forces and
        # requires a nonlinear solver
        if self.per_atom_scalar and (self.force or self.energy):
            raise ValueError(
                "per_atom_scalar fitting cannot be combined with "
                "energy/force fitting")
        if self.per_atom_scalar and self.linear:
            raise ValueError("per_atom_scalar fitting requires a "
                             "nonlinear (NN) solver")


class EshiftSection:
    name = "ESHIFT"

    def __init__(self, r: _Reader, types):
        self.eshift = {}
        if r.has_section(self.name):
            for t in types:
                self.eshift[t] = r.get(self.name, t, "0.0", "float")


class TrainshiftSection:
    """Per-element energy shifts between VASP datasets.

    Reference: fitsnap3lib/io/sections/trainshift.py (per-element float keys,
    consumed only by the VASP scraper, vasp_scraper.py:35-39,412-414).
    """

    name = "TRAINSHIFT"

    def __init__(self, r: _Reader, types):
        self.trainshift = {}
        if r.has_section(self.name):
            for t in types:
                self.trainshift[t] = r.get(self.name, t, "0.0", "float")


class GroupsSection:
    name = "GROUPS"

    _OWN_KEYS = {"group_sections", "group_types", "smartweights",
                 "random_sampling", "random_seed", "BOLTZ",
                 "vasp_use_TOTEN", "vasp_json_pathname",
                 "vasp_ignore_incomplete", "vasp_ignore_jsons",
                 "vasp_unconverged_label"}

    def __init__(self, r: _Reader, group_file=None):
        self.group_sections = r.get(
            self.name, "group_sections", "name size eweight fweight vweight").split()
        types = r.get(self.name, "group_types", "str float float float float").split()
        self.group_types = [
            {"str": str, "bool": bool, "int": int, "float": float}.get(t, str)
            for t in types]
        self.smartweights = r.get(self.name, "smartweights", "0", "bool")
        self.random_sampling = r.get(self.name, "random_sampling", "0", "bool")
        self.random_seed = r.get(self.name, "random_seed", "0", "float")
        # explicit seed (even 0) must be honored by stochastic solvers;
        # the "0" fallback alone can't distinguish set-to-zero from unset
        self.random_seed_set = (r.has_section(self.name)
                                and "random_seed" in r.keys(self.name))
        self.boltz = r.get(self.name, "BOLTZ", "0", "float")
        # VASP-scraper settings (reference vasp_scraper.py:29-33)
        self.vasp_use_TOTEN = r.get(self.name, "vasp_use_TOTEN", "0", "bool")
        self.vasp_json_pathname = r.get(self.name, "vasp_json_pathname", "vJSON")
        self.vasp_ignore_incomplete = r.get(
            self.name, "vasp_ignore_incomplete", "0", "bool")
        self.vasp_ignore_jsons = r.get(self.name, "vasp_ignore_jsons", "0", "bool")
        self.vasp_unconverged_label = r.get(
            self.name, "vasp_unconverged_label", "UNCONVERGED")
        self.group_table = {}
        # any non-reserved key names a training group (a directory), so the
        # whole section is valid by construction
        r.consume_all(self.name)
        if group_file is not None and path.exists(group_file):
            self._read_group_file(group_file)
        else:
            for key, value in r.items(self.name):
                if key in self._OWN_KEYS:
                    continue
                vals = value.split()
                if len(vals) != len(self.group_sections) - 1:
                    raise ValueError(
                        f"group {key}: expected {len(self.group_sections) - 1} "
                        f"columns, found {len(vals)}")
                self.group_table[key] = {
                    self.group_sections[i + 1]: self.group_types[i + 1](v)
                    for i, v in enumerate(vals)}

    def _read_group_file(self, group_file):
        with open(group_file) as f:
            for line in f:
                line = line.split("#")[0].strip()
                if not line:
                    continue
                vals = line.split()
                self.group_table[vals[0]] = {
                    self.group_sections[i + 1]: self.group_types[i + 1](v)
                    for i, v in enumerate(vals[1:])}


class MemorySection:
    name = "MEMORY"

    def __init__(self, r: _Reader):
        try:
            mem_bytes = sysconf("SC_PAGE_SIZE") * sysconf("SC_PHYS_PAGES")
        except (ValueError, OSError):
            mem_bytes = 0
        self.memory = r.get(self.name, "memory", str(mem_bytes), "int")
        self.override = r.get(self.name, "override", "False", "bool")


class OutfileSection:
    name = "OUTFILE"

    def __init__(self, r: _Reader, outdir=""):
        self.output_style = r.get(self.name, "output_style", "SNAP")
        self.metrics_style = r.get(self.name, "metrics_style", "MD")
        r.get(self.name, "detailed_errors", "0", "bool")  # ref outfile.py:18
        self.metric_file = path.join(outdir, r.get(self.name, "metrics", "fitsnap_metrics"))
        self.potential_name = path.join(outdir, r.get(self.name, "potential", "fitsnap_potential"))
        self.metrics = self.metric_file
        self.potential = self.potential_name
        # EXTRAS dump targets
        self.descriptor_file = path.join(outdir, r.get(self.name, "descriptors", "Descriptors.npy"))
        self.truth_file = path.join(outdir, r.get(self.name, "truth", "Truth-Ref.npy"))
        self.weights_file = path.join(outdir, r.get(self.name, "weights", "Weights.npy"))
        self.dataframe_file = path.join(outdir, r.get(self.name, "dataframe", "FitSNAP.df"))
        self.peratom_file = path.join(outdir, r.get(self.name, "peratom", "peratom.dat"))
        self.perconfig_file = path.join(outdir, r.get(self.name, "perconfig", "perconfig.dat"))
        self.configs_file = path.join(outdir, r.get(self.name, "configs", "configs.pickle"))


class PathSection:
    name = "PATH"

    def __init__(self, r: _Reader, infile_directory=""):
        self.infile_directory = infile_directory
        self.datapath = path.join(infile_directory, r.get(self.name, "dataPath", "JSON"))
        self.group_file = path.join(infile_directory, r.get(self.name, "groupFile", "grouplist.in"))
        self.has_group_file = r.get(self.name, "groupFile", "None") != "None"


class ReferenceSection:
    name = "REFERENCE"

    def __init__(self, r: _Reader):
        self.units = r.get(self.name, "units", "metal").lower()
        self.atom_style = r.get(self.name, "atom_style", "atomic").lower()
        self.lmp_pairdecl = [
            "pair_style " + r.get(self.name, "pair_style", "zero 10.0")]
        for key, value in r.items(self.name):
            if key.startswith("pair_coeff"):
                r.consume(self.name, key)
                self.lmp_pairdecl.append("pair_coeff " + value)
        if len(self.lmp_pairdecl) == 1:
            self.lmp_pairdecl.append("pair_coeff * *")


class ScraperSection:
    name = "SCRAPER"

    def __init__(self, r: _Reader):
        self.scraper = r.get(self.name, "scraper", "JSON")
        self.save_group_scrape = r.get(self.name, "save_group_scrape", "None")
        self.read_group_scrape = r.get(self.name, "read_group_scrape", "None")
        self.properties = {
            "Stress": ["pressure", "Metal", "Metal"],
            "Lattice": ["length", "Metal", "Metal"],
            "Energy": ["energy", "Metal", "Metal"],
            "Positions": ["length", "Metal", "Metal"],
            "Forces": ["force", "Metal", "Metal"],
        }
        arr = r.get(self.name, "property_array", "None")
        if arr != "None":
            arr = arr.replace("=", "").replace(":", "").replace(";", "\n").split("\n")
            for item in arr:
                if item.strip():
                    parts = item.split()
                    self.properties[parts[0].capitalize()] = parts[1:]


class SolverSection:
    name = "SOLVER"

    def __init__(self, r: _Reader):
        self.solver = r.get(self.name, "solver", "SVD")
        self.true_multinode = 1 if self.solver == "ScaLAPACK" else 0
        self.normalweight = r.get(self.name, "normalweight", "-12", "float")
        self.normratio = r.get(self.name, "normratio", "0.5", "float")
        self.compute_testerrs = r.get(self.name, "compute_testerrs", "0", "bool")
        self.detailed_errors = r.get(self.name, "detailed_errors", "0", "bool")
        self.nsam = r.get(self.name, "nsam",
                          "133" if self.solver == "MCMC" else "0", "int")
        self.cov_nugget = r.get(self.name, "cov_nugget", "0.0", "float")
        self.mcmc_num = r.get(self.name, "mcmc_num", "10000", "int")
        self.mcmc_gamma = r.get(self.name, "mcmc_gamma", "0.01", "float")
        self.mcmc_sigma = r.get(self.name, "mcmc_sigma", "0.1", "float")
        self.merr_mult = r.get(self.name, "merr_mult", "0", "bool")
        self.merr_method = r.get(self.name, "merr_method", "abc")
        self.merr_cfs = r.get(self.name, "merr_cfs", "all")
        self.merr_sampler = r.get(self.name, "merr_sampler", "bfgs").lower()
        if self.merr_sampler not in ("bfgs", "mcmc"):
            raise ValueError(
                f"merr_sampler must be 'bfgs' or 'mcmc', got "
                f"{self.merr_sampler!r}")


class RidgeSection:
    name = "RIDGE"

    def __init__(self, r: _Reader):
        self.alpha = r.get(self.name, "alpha", "1.0e-6", "float")
        self.local_solver = r.get(self.name, "local_solver", "0", "bool")


class LassoSection:
    name = "LASSO"

    def __init__(self, r: _Reader):
        self.alpha = r.get(self.name, "alpha", "1.0e-6", "float")
        self.max_iter = r.get(self.name, "max_iter", "2000", "int")


class ArdSection:
    name = "ARD"

    def __init__(self, r: _Reader):
        self.alphabig = r.get(self.name, "alphabig", "1.0e-12", "float")
        self.alphasmall = r.get(self.name, "alphasmall", "1.0e-14", "float")
        self.lambdabig = r.get(self.name, "lambdabig", "1.0e-6", "float")
        self.lambdasmall = r.get(self.name, "lambdasmall", "1.0e-6", "float")
        self.threshold_lambda = r.get(self.name, "threshold_lambda", "100000", "int")
        self.directmethod = r.get(self.name, "directmethod", "0", "bool")
        self.logcut = r.get(self.name, "logcut", "-4", "float")
        self.scap = r.get(self.name, "scap", "1.0", "float")
        self.scai = r.get(self.name, "scai", "1.0", "float")


class NetworkSection:
    """NN solver settings; accepts both [PYTORCH] and [NETWORK] section names
    for input compatibility with the reference's examples."""

    def __init__(self, r: _Reader, name, num_desc):
        self.name = name
        layer_sizes = r.get(name, "layer_sizes", "num_desc 64 64 1").split()
        if layer_sizes[0] == "num_desc":
            # ACE label counts are only known once the calculator builds its
            # plan; 0 marks "resolve from descriptor width at training time"
            layer_sizes[0] = str(num_desc)
        self.layer_sizes = [int(x) for x in layer_sizes]
        self.learning_rate = r.get(name, "learning_rate", "1e-4", "float")
        self.num_epochs = r.get(name, "num_epochs", "10", "int")
        self.batch_size = r.get(name, "batch_size", "10", "int")
        self.energy_weight = r.get(name, "energy_weight", "nan", "float")
        self.force_weight = r.get(name, "force_weight", "nan", "float")
        self.global_weight_bool = self.energy_weight == self.energy_weight  # not NaN
        self.training_fraction = r.get(name, "training_fraction", "1.0", "float")
        self.multi_element_option = r.get(name, "multi_element_option", "1", "int")
        self.manual_seed_flag = r.get(name, "manual_seed_flag", "0", "bool")
        self.shuffle_flag = r.get(name, "shuffle_flag", "1", "bool")
        self.save_state_output = r.get(name, "save_state_output", "None")
        self.save_state_input = r.get(name, "save_state_input", "None")
        self.output_file = r.get(name, "output_file", "FitTorch_Pytorch.pt")
        self.dtype_str = r.get(name, "dtype", "float32")
        self.save_freq = r.get(name, "save_freq", "10", "int")
        # descriptor-gradient strategy (this framework's extension; the
        # reference always materializes dgrad rows, ~20 GB RAM at 10k
        # configs, docs/source/Pytorch.rst:258-259):
        #   precompute - store per-pair dB/dD once (fastest small datasets)
        #   otf        - keep only positions device-resident, build neighbor
        #                lists on device, recompute descriptors inside the
        #                training step, forces by autodiff (memory O(atoms),
        #                datasets far beyond HBM-resident dgrad)
        #   cached     - neighbor tensors (disp/jidx/mask, ~55x smaller than
        #                dgrad) cached device-resident once; the training
        #                step recomputes descriptors from them with analytic
        #                per-pair force contraction (fastest large datasets;
        #                SNAP base descriptors)
        #   auto       - precompute if dgrad fits FITSNAP_TPU_NN_G_LIMIT
        #                (default 2 GiB), else cached if supported and the
        #                neighbor tensors fit FITSNAP_TPU_NN_NEIGH_LIMIT
        #                (default 4 GiB), else otf
        # ReduceLROnPlateau equivalent (reference solvers/pytorch.py:113-118
        # constructs one with mode=min, factor=0.5, patience=49,
        # threshold=1e-4, threshold_mode=abs) — but upstream NEVER calls
        # scheduler.step(), so its effective trajectory is constant-LR.
        # Default OFF for trajectory parity with identical input files;
        # lr_plateau_flag=1 opts into a scheduler that actually steps
        # (the solver logs when it first reduces the LR).
        self.lr_plateau_flag = r.get(name, "lr_plateau_flag", "0", "bool")
        self.lr_plateau_factor = r.get(
            name, "lr_plateau_factor", "0.5", "float")
        self.lr_plateau_patience = r.get(
            name, "lr_plateau_patience", "49", "int")
        self.lr_plateau_threshold = r.get(
            name, "lr_plateau_threshold", "0.0001", "float")
        self.lr_min = r.get(name, "lr_min", "0.0", "float")
        self.dgrad_mode = r.get(name, "dgrad_mode", "auto").lower()
        if self.dgrad_mode not in ("auto", "precompute", "otf", "cached"):
            raise ValueError(
                f"[{name}] dgrad_mode must be auto/precompute/otf/cached, "
                f"got {self.dgrad_mode!r}")
        # accepted-for-compatibility (reference pytorch.py:13-15, jax.py:23)
        r.get(name, "num_elements", "0", "int")
        r.get(name, "silence_ace_multi_warning", "0", "bool")
        r.get(name, "output_style", "None")
        r.get(name, "opt_state_input", "None")
        r.get(name, "opt_state_output", "None")


class ExtrasSection:
    name = "EXTRAS"

    def __init__(self, r: _Reader):
        self.multinode_testing = r.get(self.name, "multinode_testing", "0", "bool")
        self.apply_transpose = r.get(self.name, "apply_transpose", "0", "bool")
        self.only_test = r.get(self.name, "only_test", "0", "bool")
        self.dump_a = r.get(self.name, "dump_descriptors", "0", "bool")
        self.dump_b = r.get(self.name, "dump_truth", "0", "bool")
        self.dump_w = r.get(self.name, "dump_weights", "0", "bool")
        self.dump_dataframe = r.get(self.name, "dump_dataframe", "0", "bool")
        self.dump_peratom = r.get(self.name, "dump_peratom", "0", "bool")
        self.dump_perconfig = r.get(self.name, "dump_perconfig", "0", "bool")
        self.dump_configs = r.get(self.name, "dump_configs", "0", "bool")


class Config:
    """Top-level parsed configuration.

    Args:
        input: path to an INI input script, or a nested dict of sections.
        arglist: optional CLI-style argument list (library mode).
    """

    def __init__(self, input=None, arglist=None):
        self.args = parse_cmdline(arglist)
        self.input = input

        cp = configparser.ConfigParser(inline_comment_prefixes="#")
        cp.optionxform = str
        self.infile = None
        if isinstance(input, str):
            self.infile = input
        elif isinstance(input, dict):
            for k1, d1 in input.items():
                cp[k1] = {}
                for k2, v2 in d1.items():
                    cp[k1][str(k2)] = str(v2)
        elif input is None:
            if self.args.infile is None:
                raise FileNotFoundError("no input file given")
            self.infile = self.args.infile

        if self.infile is not None:
            if not Path(self.infile).is_file():
                raise FileNotFoundError(f"Input file not found: {self.infile}")
            cp.read(self.infile)

        for kwg, kwn, kwv in self.args.keyword_replacements:
            if kwg not in cp:
                raise ValueError(f"{kwg} is not a valid keyword group")
            cp[kwg][kwn] = kwv

        # run provenance hash (reference `io/input.py:44`)
        h = hashlib.md5()
        h.update(str(time.time()).encode())
        h.update(str(random.random()).encode())
        self.hash = h.hexdigest()

        r = _Reader(cp)
        self._reader = r
        infile_dir = str(Path(self.infile).parent) if self.infile else ""
        outdir = infile_dir if self.args.relative else ""

        self.sections = {}
        self.sections["CALCULATOR"] = CalculatorSection(r)
        if r.has_section("BISPECTRUM"):
            self.sections["BISPECTRUM"] = BispectrumSection(r)
            desc_section = self.sections["BISPECTRUM"]
        elif r.has_section("ACE"):
            self.sections["ACE"] = AceSection(r)
            desc_section = self.sections["ACE"]
        elif r.has_section("CUSTOM"):
            self.sections["CUSTOM"] = CustomSection(r)
            desc_section = self.sections["CUSTOM"]
        else:
            raise ValueError("need a BISPECTRUM, ACE, or CUSTOM section")
        self.sections["ESHIFT"] = EshiftSection(r, desc_section.types)
        if r.has_section("TRAINSHIFT"):
            self.sections["TRAINSHIFT"] = TrainshiftSection(r, desc_section.types)
        self.sections["PATH"] = PathSection(r, infile_dir)
        pf = self.sections["PATH"].group_file if self.sections["PATH"].has_group_file else None
        self.sections["GROUPS"] = GroupsSection(r, pf)
        self.sections["MEMORY"] = MemorySection(r)
        self.sections["OUTFILE"] = OutfileSection(r, outdir)
        self.sections["REFERENCE"] = ReferenceSection(r)
        self.sections["SCRAPER"] = ScraperSection(r)
        self.sections["SOLVER"] = SolverSection(r)
        self.sections["EXTRAS"] = ExtrasSection(r)
        if r.has_section("RIDGE"):
            self.sections["RIDGE"] = RidgeSection(r)
        if r.has_section("LASSO"):
            self.sections["LASSO"] = LassoSection(r)
        if r.has_section("ARD"):
            self.sections["ARD"] = ArdSection(r)
        ncoeff = getattr(desc_section, "ncoeff", 0) or 0
        for nn_name in ("PYTORCH", "NETWORK", "JAX"):
            if r.has_section(nn_name):
                self.sections[nn_name] = NetworkSection(r, nn_name, ncoeff)
        self._validate(r)

    # section <-> CALCULATOR.calculator pairing (reference
    # `sections.py:93-96 _check_if_used`, `bispectrum.py:16`)
    _CALC_SECTION = {"LAMMPSSNAP": "BISPECTRUM", "LAMMPSPACE": "ACE",
                     "LAMMPSCUSTOM": "CUSTOM", "BASIC": "BISPECTRUM"}

    _KNOWN_SECTIONS = {
        "CALCULATOR", "BISPECTRUM", "ACE", "CUSTOM", "ESHIFT", "TRAINSHIFT",
        "PATH", "GROUPS", "MEMORY", "OUTFILE", "REFERENCE", "SCRAPER",
        "SOLVER", "EXTRAS", "RIDGE", "LASSO", "ARD", "PYTORCH", "NETWORK",
        "JAX", "DEFAULT", "TEMPLATE",
    }

    def _validate(self, r: _Reader):
        """Reject unknown sections/keys and inconsistent cross-section picks.

        The reference validates allowed keys per section
        (`io/sections/sections.py:44-50`) and asserts solver/calculator
        sections are actually selected (`sections.py:93-96`); a typo'd
        `twojmax` must not silently fit garbage.
        """
        calcname = self.sections["CALCULATOR"].calculator.upper()
        want = self._CALC_SECTION.get(calcname)
        if want is None:
            raise ValueError(f"Unknown calculator: {calcname}")
        for sec in ("BISPECTRUM", "ACE", "CUSTOM"):
            if r.has_section(sec) and sec != want:
                raise ValueError(
                    f"{sec} section is in input, but calculator is "
                    f"{calcname} (expects [{want}])")
        solver = self.sections["SOLVER"].solver.upper()
        for sec in ("RIDGE", "LASSO", "ARD"):
            if r.has_section(sec) and solver != sec:
                raise ValueError(
                    f"{sec} section is in input, but not set as solver")
        for sec in ("PYTORCH", "NETWORK", "JAX"):
            if r.has_section(sec) and solver != sec:
                raise ValueError(
                    f"{sec} section is in input, but not set as solver")
        # the cross-section checks above run FIRST so e.g. an [ACE] section
        # under calculator=LAMMPSSNAP gets the dedicated message, not a
        # generic unmatched-variable error for its never-read keys
        r.validate(self._KNOWN_SECTIONS)

    def has_section(self, name):
        return name in self.sections
