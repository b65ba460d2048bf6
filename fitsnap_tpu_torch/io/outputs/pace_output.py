"""PACE potential writers: .acecoeff, .yace, .mod + metrics.

Copy of `fitsnap_tpu/io/outputs/pace_output.py`.

File roles mirror reference `fitsnap3lib/io/outputs/pace.py`: the `.yace` is
the LAMMPS ML-PACE potential (ctilde functions with fitted betas folded in),
the `.acecoeff` lists the raw coefficients.  The ctilde tables come from
this framework's own coupling plan (`fitsnap_tpu_torch.ops.ace`), so the
file is self-consistent with the descriptors used in the fit.
"""

from datetime import datetime

import numpy as np


class PaceOutput:
    def __init__(self, name, config):
        self.config = config
        self.name = name

    def output(self, coeffs, errors):
        self.write_potential(coeffs)
        self.write_errors(errors)

    def write_potential(self, coeffs):
        if coeffs is None:
            return
        pot = self.config.sections["OUTFILE"].potential_name
        if not pot:
            return
        sec = self.config.sections["ACE"]
        with open(pot + ".acecoeff", "wt") as f:
            f.write(self._coeff_string(np.asarray(coeffs)))
        with open(pot + ".yace", "wt") as f:
            f.write(self._yace_string(np.asarray(coeffs)))
        with open(pot + ".mod", "wt") as f:
            f.write(self._mod_string())
        if self.config.args.tarball:
            from fitsnap_tpu_torch.io.outputs.common import write_tarball
            write_tarball(self.config, [".acecoeff", ".yace", ".mod"])

    def _plan(self):
        # the calculator owns the plan; reconstruct if needed
        from fitsnap_tpu_torch.ops.ace import build_ace_plan
        return build_ace_plan(self.config.sections["ACE"])

    def _coeff_string(self, coeffs):
        sec = self.config.sections["ACE"]
        out = (f"# fitsnap_tpu_torch ACE fit generated on {datetime.now()} "
               f"with Hash: {self.config.hash}\n\n")
        out += f"{sec.numtypes} {sec.ncoeff + 1}\n"
        plan = self._plan()
        per_type = len(plan.labels) // sec.numtypes
        has_const = not sec.bzeroflag
        for t, elname in enumerate(sec.types):
            out += f"{elname}\n"
            if has_const:
                out += f" {coeffs[t]:<30.18} #  const\n"
            base = sec.numtypes if has_const else 0
            for i in range(per_type):
                li = t * per_type + i
                lab = plan.labels[li]
                out += (f" {coeffs[base + li]:<30.18} "
                        f"#  mu0={lab[0]} mu={list(lab[1])} n={list(lab[2])} "
                        f"l={list(lab[3])} L={list(lab[4])}\n")
        out += "\n# End of potential"
        return out

    def _yace_string(self, coeffs):
        """LAMMPS ML-PACE ctilde potential (yaml)."""
        sec = self.config.sections["ACE"]
        plan = self._plan()
        has_const = not sec.bzeroflag
        base = sec.numtypes if has_const else 0
        e0s = [float(coeffs[t]) if has_const else 0.0
               for t in range(sec.numtypes)]
        out = "elements: [" + ", ".join(sec.types) + "]\n"
        out += f"E0: [{', '.join(str(e) for e in e0s)}]\n"
        out += "deltaSplineBins: 0.001\n"
        out += "embeddings:\n"
        for t in range(sec.numtypes):
            out += (f"  {t}: {{ndensity: 1, FS_parameters: [1.0, 1.0], "
                    "npoti: FinnisSinclair, rho_core_cutoff: 100000, "
                    "drho_core_cutoff: 250}\n")
        out += "bonds:\n"
        nradmax = max(sec.nmax)
        rcut = np.asarray(plan.rcut)
        lmbda = np.asarray(plan.lmbda)
        rcin = np.asarray(plan.rcinner)
        dcin = np.asarray(plan.drcinner)
        for t1 in range(sec.numtypes):
            for t2 in range(sec.numtypes):
                crad = np.zeros((nradmax, plan.lmax + 1, plan.nradbase))
                for n in range(nradmax):
                    crad[n, :, n] = 1.0
                out += (f"  [{t1}, {t2}]: {{nradmax: {nradmax}, "
                        f"lmax: {plan.lmax}, "
                        f"nradbasemax: {plan.nradbase}, "
                        "radbasename: ChebExpCos, "
                        f"radparameters: [{lmbda[t1, t2]}], "
                        f"radcoefficients: {crad.tolist()}, "
                        "prehc: 0, "
                        f"lambdahc: {lmbda[t1, t2]}, "
                        f"rcut: {rcut[t1, t2]}, "
                        f"dcut: 0.01, rcut_in: {rcin[t1, t2]}, "
                        f"dcut_in: {dcin[t1, t2]}, "
                        "inner_cutoff_type: distance}\n"
                        )
        from fitsnap_tpu_torch.ops.ace import plan_terms
        all_terms = plan_terms(plan)
        out += "functions:\n"
        per_type = len(plan.labels) // sec.numtypes
        for t in range(sec.numtypes):
            out += f"  {t}:\n"
            for i in range(per_type):
                li = t * per_type + i
                mu0, mus, ns, ls, Ls = plan.labels[li]
                c = float(coeffs[base + li])
                ms_combs = []
                ctildes = []
                for mvec, cc in all_terms[li].items():
                    ms_combs += list(mvec)
                    ctildes.append(cc * c)
                rank = len(mus)
                out += ("    - {" +
                        f"mu0: {mu0}, rank: {rank}, ndensity: 1, "
                        f"num_ms_combs: {len(ctildes)}, "
                        f"mus: {list(mus)}, ns: {list(ns)}, "
                        f"ls: {list(ls)}, "
                        f"ms_combs: {ms_combs}, "
                        f"ctildes: {ctildes}" + "}\n")
        return out

    def _mod_string(self):
        sec = self.config.sections["ACE"]
        ref = self.config.sections["REFERENCE"]
        ps = ref.lmp_pairdecl[0]
        fname = self.config.sections["OUTFILE"].potential_name.split("/")[-1]
        out = "# This file was generated by fitsnap_tpu_torch.\n"
        out += f"# Hash: {self.config.hash}\n\n"
        if "hybrid" in ps:
            if "zero" in ps.split():
                sp = ps.split()
                zi = sp.index("zero")
                del sp[zi]
                del sp[zi]
                ps = " ".join(sp)
            out += ps + " pace product\n"
            for pc in ref.lmp_pairdecl[1:]:
                out += f"{pc}\n" if "zero" not in pc else ""
            out += f"pair_coeff * * pace {fname}.yace " \
                + " ".join(sec.types)
        else:
            out += "pair_style pace product\n"
            out += f"pair_coeff * * {fname}.yace " + " ".join(sec.types)
        return out

    def write_errors(self, errors):
        from fitsnap_tpu_torch.io.outputs.snap_output import SnapOutput
        SnapOutput.write_errors(self, errors)

    def read_fit(self):
        """Read an existing .acecoeff back for EXTRAS only_test runs.

        (The reference leaves this unimplemented for PACE, pace.py:80-84;
        the file format is ours so a reader is straightforward.)
        """
        pot = self.config.sections["OUTFILE"].potential_name
        vals = []
        with open(pot + ".acecoeff") as f:
            for ln in f:
                s = ln.strip()
                if not s or s.startswith("#"):
                    continue
                parts = s.split()
                if len(parts) >= 2 and parts[0].isdigit() \
                        and parts[1].isdigit():
                    continue  # "numtypes ncoeff+1" header
                try:
                    vals.append(float(parts[0]))
                except ValueError:
                    continue  # element-name line
        return np.asarray(vals)
