"""Shared output helpers: LAMMPS template input + tarball packaging.

Reference: `fitsnap3lib/io/outputs/snap.py:44-56` (tarball of the emitted
potential files keyed by the run hash) and `snap.py:223-260` (the template
`in.lammps` NVE script included in the tarball).
"""

import tarfile
from os import path


def lammps_input_script(config):
    """Template LAMMPS NVE input that includes the written potential."""
    pot = config.sections["OUTFILE"].potential_name.split("/")[-1]
    ref = config.sections["REFERENCE"]
    return "\n".join([
        "# LAMMPS template input written by fitsnap_tpu_torch.",
        "# Runs a NVE simulation at specified temperature and timestep.",
        "",
        "variable timestep equal 0.5e-3",
        "variable temperature equal 600",
        "",
        f"units {ref.units}",
        f"atom_style {ref.atom_style}",
        "",
        "# Supply your own data file below",
        "read_data DATA",
        "",
        f"include {pot}.mod",
        "",
        "timestep ${timestep}",
        "neighbor 1.0 bin",
        "velocity all create ${temperature} 10101 rot yes mom yes",
        "fix 1 all nve",
        "run 1000",
        "",
    ])


def write_tarball(config, suffixes):
    """Package the written potential files as fit-{hash}.tar.gz.

    suffixes: file suffixes of the potential files just written (e.g.
    [".snapcoeff", ".snapparam", ".mod"]).  The archive also carries a
    template in.lammps, like the reference's.
    """
    pot = config.sections["OUTFILE"].potential_name
    prefix = pot.split("/")[-1]
    lmp_in = path.join(path.dirname(pot) or ".", "in.lammps")
    with open(lmp_in, "wt") as f:
        f.write(lammps_input_script(config))
    with tarfile.open(f"fit-{config.hash}.tar.gz", "w:gz") as fp:
        for sfx in suffixes:
            if path.exists(pot + sfx):
                fp.add(pot + sfx, arcname=prefix + sfx)
        fp.add(lmp_in, arcname="in.lammps")
