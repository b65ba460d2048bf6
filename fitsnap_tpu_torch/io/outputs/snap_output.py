"""SNAP potential file writers (.snapcoeff / .snapparam / .mod) + metrics.

Copy of `fitsnap_tpu/io/outputs/snap_output.py`: the linear writers and,
for a nonlinear (NN) fit, the ML-IAP descriptor and pair-style files.

File formats match reference `fitsnap3lib/io/outputs/snap.py` so the emitted
potentials drop into LAMMPS (`pair_style snap`) unchanged and metric files
diff against the reference's.
"""

from datetime import datetime

import numpy as np


class SnapOutput:
    def __init__(self, name, config):
        self.config = config
        self.name = name

    def output(self, coeffs, errors):
        if self.config.sections["CALCULATOR"].nonlinear:
            self.write_nn(errors)
            return
        self.write_lammps(coeffs)
        self.write_errors(errors)

    def write_nn(self, errors):
        """Nonlinear outputs: ML-IAP descriptor + pair-style include files
        (reference `io/outputs/snap.py:67`); the network itself is the `.pt`
        the solver exports."""
        pot = self.config.sections["OUTFILE"].potential_name
        if pot:
            with open(pot + ".mliap.descriptor", "wt") as f:
                f.write(self._mliap_string())
            with open(pot + ".mod", "wt") as f:
                f.write(self._mliap_mod())
        self.write_errors(errors)

    def _mliap_string(self):
        sec = self.config.sections["BISPECTRUM"]
        ref = self.config.sections["REFERENCE"]
        out = "# required\n"
        out += f"rcutfac {sec.rcutfac}\n"
        out += f"twojmax {max(sec.twojmax)}\n\n"
        out += "#elements\n"
        out += f"nelems {sec.numtypes}\n"
        out += "elems " + " ".join(sec.types) + "\n"
        out += "radelems " + " ".join(str(r) for r in sec.radelem) + "\n"
        out += "welems " + " ".join(str(w) for w in sec.wj) + "\n"
        if sec.switchinnerflag:
            out += f"sinnerelems {sec.sinner}\n"
            out += f"dinnerelems {sec.dinner}\n"
        out += "\n\n# optional\n"
        out += f"rfac0 {sec.rfac0}\n"
        out += f"rmin0 {sec.rmin0}\n"
        out += f"switchinnerflag {sec.switchinnerflag}\n"
        out += f"bzeroflag {sec.bzeroflag}\n\n"
        out += f"# fitsnap_tpu_torch generated Hash: {self.config.hash}\n"
        out += f"# units {ref.units}\n# atom_style {ref.atom_style}\n"
        out += "\n".join("# " + s for s in ref.lmp_pairdecl) + "\n"
        return out

    def _mliap_mod(self):
        ref = self.config.sections["REFERENCE"]
        sec = self.config.sections["BISPECTRUM"]
        snap_filename = self.config.sections["OUTFILE"].potential_name \
            .split("/")[-1]
        pt_filename = "FitTorch_Pytorch.pt"
        for name in ("PYTORCH", "NETWORK", "JAX"):
            if name in self.config.sections:
                pt_filename = self.config.sections[name].output_file \
                    .split("/")[-1]
                break
        if not pt_filename.endswith(".pt"):
            pt_filename += ".pt"
        ps = ref.lmp_pairdecl[0]
        out = f"# fitsnap_tpu_torch generated Hash: {self.config.hash}\n"
        if "hybrid" in ps:
            if "zero" in ps.split():
                sp = ps.split()
                zi = sp.index("zero")
                del sp[zi]
                del sp[zi]
                ps = " ".join(sp)
            out += ps + (f" mliap model mliappy {pt_filename} descriptor "
                         f"sna {snap_filename}.mliap.descriptor\n")
            for pc in ref.lmp_pairdecl[1:]:
                out += f"{pc}\n" if "zero" not in pc else ""
            out += "pair_coeff * * mliap " + " ".join(sec.types)
        else:
            out += (f"pair_style mliap model mliappy {pt_filename} "
                    f"descriptor sna {snap_filename}.mliap.descriptor\n")
            out += "pair_coeff * * " + " ".join(sec.types)
        return out

    # ---------------- potential files ----------------

    def write_lammps(self, coeffs):
        if coeffs is None:
            return
        pot = self.config.sections["OUTFILE"].potential_name
        if not pot:
            return
        with open(pot + ".snapcoeff", "wt") as f:
            f.write(self._coeff_string(np.asarray(coeffs)))
        with open(pot + ".snapparam", "wt") as f:
            f.write(self._param_string())
        with open(pot + ".mod", "wt") as f:
            f.write(self._potential_file())
        if self.config.args.tarball:
            from fitsnap_tpu_torch.io.outputs.common import write_tarball
            write_tarball(self.config, [".snapcoeff", ".snapparam", ".mod"])

    def _coeff_string(self, coeffs):
        sec = self.config.sections["BISPECTRUM"]
        numtypes = sec.numtypes
        ncoeff = sec.ncoeff
        coeffs = coeffs.reshape((numtypes, -1))
        blank2js = np.asarray(sec.blank2J).reshape((numtypes, -1))
        if sec.bzeroflag:
            blank2js = np.insert(blank2js, 0, [1.0], axis=1)
        coeffs = np.multiply(coeffs, blank2js)
        out = (f"# fitsnap_tpu_torch fit generated on {datetime.now()} "
               f"with Hash: {self.config.hash}\n\n")
        out += f"{numtypes} {ncoeff + 1}\n"
        for ielem, (elname, rjval, wjval) in enumerate(
                zip(sec.types, sec.radelem, sec.wj)):
            bnames = [[0]] + sec.blist[ielem * ncoeff:(ielem + 1) * ncoeff]
            out += f"{elname} {rjval} {wjval}\n"
            out += "\n".join(
                f" {bval:<30.18} #  B{bname} "
                for bval, bname in zip(coeffs[ielem], bnames))
            out += "\n"
        out += "\n# End of potential"
        return out

    def _param_string(self):
        sec = self.config.sections["BISPECTRUM"]
        ref = self.config.sections["REFERENCE"]
        chemflag_int = 1 if sec.chemflag != 0 else 0
        out = "# required\n"
        out += f"rcutfac {sec.rcutfac}\n"
        out += f"twojmax {max(sec.twojmax)}\n\n"
        out += "# optional\n"
        out += f"rfac0 {sec.rfac0}\n"
        out += f"rmin0 {sec.rmin0}\n"
        out += f"bzeroflag {sec.bzeroflag}\n"
        out += f"wselfallflag {sec.wselfallflag}\n"
        out += f"chemflag {chemflag_int}\n"
        out += f"bnormflag {sec.bnormflag}\n"
        out += f"switchinnerflag {sec.switchinnerflag}\n"
        out += f"quadraticflag {sec.quadraticflag}\n"
        if sec.switchinnerflag:
            out += f"sinner {sec.sinner}\n"
            out += f"dinner {sec.dinner}\n"
        out += "\n# This file was generated by fitsnap_tpu_torch.\n"
        out += f"# Hash: {self.config.hash}\n"
        out += "# REFERENCE section settings:\n"
        out += f"# units {ref.units}\n# atom_style {ref.atom_style}\n"
        out += "\n".join("# " + s for s in ref.lmp_pairdecl) + "\n"
        return out

    def _potential_file(self):
        ref = self.config.sections["REFERENCE"]
        sec = self.config.sections["BISPECTRUM"]
        ps = ref.lmp_pairdecl[0]
        snap_filename = self.config.sections["OUTFILE"].potential_name.split("/")[-1]
        out = "# This file was generated by fitsnap_tpu_torch.\n"
        out += f"# Hash: {self.config.hash}\n\n"
        if "hybrid" in ps:
            if "zero" in ps.split():
                sp = ps.split()
                zi = sp.index("zero")
                del sp[zi]
                del sp[zi]
                ps = " ".join(sp)
            out += ps + " snap\n"
            for pc in ref.lmp_pairdecl[1:]:
                out += f"{pc}\n" if "zero" not in pc else ""
            pc_snap = (f"pair_coeff * * snap {snap_filename}.snapcoeff "
                       f"{snap_filename}.snapparam")
        else:
            out += "pair_style snap\n"
            pc_snap = (f"pair_coeff * * {snap_filename}.snapcoeff "
                       f"{snap_filename}.snapparam")
        for t in sec.types:
            pc_snap += f" {t}"
        return out + pc_snap

    def read_fit(self):
        """Read an existing .snapcoeff back (reference `snap.py:90`)."""
        sec = self.config.sections["BISPECTRUM"]
        pot = self.config.sections["OUTFILE"].potential_name
        with open(pot + ".snapcoeff") as f:
            f.readline()
            f.readline()
            num_types, ncoeff = [int(x) for x in f.readline().split()]
            assert ncoeff == sec.ncoeff + 1
            assert num_types == sec.numtypes
            fit = np.zeros((num_types, ncoeff - 1))
            for i in range(num_types):
                f.readline()
                f.readline()
                for j in range(ncoeff - 1):
                    fit[i][j] = float(f.readline().split()[0])
        return fit.flatten()

    # ---------------- metrics ----------------

    def write_errors(self, errors):
        """Write the grouped error table (`solvers.solver.ErrorTable`):
        MD, CSV, SSV and JSON as text, DF as the JAX package's pickled
        pandas DataFrame."""
        if isinstance(errors, list):
            return
        fname = self.config.sections["OUTFILE"].metric_file
        style = self.config.sections["OUTFILE"].metrics_style
        if not fname:
            return
        if style == "MD":
            text = errors.to_markdown()
        elif style in ("CSV", "SSV"):
            text = errors.to_csv(sep="," if style == "CSV" else " ")
        elif style == "JSON":
            text = errors.to_json()
        elif style == "DF":
            errors.to_dataframe().to_pickle(fname)
            return
        else:
            raise NotImplementedError(f"metrics style {style}")
        with open(fname, "wt") as f:
            f.write(text)
