"""Convert VASP outputs to FitSNAP-format JSON training files.

Behavioral equivalent of the reference's `tools/VASP2JSON.py` (OUTCAR) and
`tools/VASPxml2JSON.py` (vasprun.xml): one JSON per ionic step, with the
`Dataset -> Data[0]` schema the JSON scraper consumes (Positions, Lattice,
AtomTypes, Energy, Forces, Stress + *Style unit keys).

CLI:
    python -m fitsnap_tpu_torch.tools.vasp2json OUTCAR  my_training_dir/prefix
    python -m fitsnap_tpu_torch.tools.vasp2json vasprun.xml out/prefix

Copy of `fitsnap_tpu/tools/vasp2json.py`, on the port's `_parse_outcar`.
"""

import json
import os
import sys

import numpy as np


def _dataset(positions, lattice, types, energy, forces, stress, label):
    data = {
        "Positions": np.asarray(positions, float).tolist(),
        "Lattice": np.asarray(lattice, float).tolist(),
        "AtomTypes": list(types),
        "NumAtoms": len(types),
        "Energy": float(energy),
        "Forces": np.asarray(forces, float).tolist(),
    }
    if stress is not None:
        data["Stress"] = np.asarray(stress, float).tolist()
    return {"Dataset": {
        "Data": [data],
        "PositionsStyle": "angstrom",
        "AtomTypeStyle": "chemicalsymbol",
        "StressStyle": "kB",
        "LatticeStyle": "angstrom",
        "EnergyStyle": "electronvolt",
        "ForcesStyle": "eVperAngstrom",
        "Label": label,
    }}


def outcar_to_json(outcar_path, out_prefix, write=True):
    """All converged ionic steps of one OUTCAR -> JSON dicts (and files)."""
    from fitsnap_tpu_torch.scrapers.vasp_scraper import (
        _parse_outcar, _step_to_dataset)

    with open(outcar_path) as f:
        steps = _parse_outcar(f.read(), filename=outcar_path)
    out = []
    group = os.path.basename(os.path.dirname(os.path.abspath(outcar_path)))
    for i, step in enumerate(steps, start=1):
        name = f"{out_prefix}{i}.json"
        doc = _step_to_dataset(step, group, os.path.basename(name),
                               use_toten=False)
        out.append(doc)
        if write:
            os.makedirs(os.path.dirname(name) or ".", exist_ok=True)
            with open(name, "w") as f:
                f.write(f"# Generated by fitsnap_tpu_torch vasp2json from "
                        f"{outcar_path}\n")
                json.dump(doc, f, indent=2)
    return out


def vasprun_to_json(xml_path, out_prefix, write=True,
                    write_unconverged=False):
    """All converged ionic steps of a vasprun.xml -> JSON dicts (and files).

    A step whose SCF loop ran the full NELM iterations is treated as
    electronically unconverged and skipped (the reference converters'
    guard, `tools/VASPxml2JSON.py:104` / `tools/xml2xyz.py:112`); pass
    `write_unconverged=True` to keep such steps.
    """
    import xml.etree.ElementTree as ET

    root = ET.parse(xml_path).getroot()
    # element symbols in atom order
    types = [rc.find("c").text.strip()
             for rc in root.findall("atominfo/array[@name='atoms']/set/rc")]
    nelm = root.find("parameters/separator[@name='electronic']/"
                     "separator[@name='electronic convergence']/"
                     "i[@name='NELM']")
    nelm = int(nelm.text) if nelm is not None else None
    out = []
    for i, calc in enumerate(root.findall("calculation"), start=1):
        if (not write_unconverged and nelm is not None
                and len(calc.findall("scstep")) == nelm):
            continue   # SCF hit NELM: electronically unconverged
        struct = calc.find("structure")
        basis = [[float(x) for x in v.text.split()] for v in
                 struct.findall("crystal/varray[@name='basis']/v")]
        fracpos = [[float(x) for x in v.text.split()] for v in
                   struct.findall("varray[@name='positions']/v")]
        cart = np.asarray(fracpos) @ np.asarray(basis)
        forces = [[float(x) for x in v.text.split()] for v in
                  calc.findall("varray[@name='forces']/v")]
        sv = calc.findall("varray[@name='stress']/v")
        stress = [[float(x) for x in v.text.split()] for v in sv] if sv \
            else None
        e = calc.find("energy/i[@name='e_0_energy']")
        if e is None:
            continue
        doc = _dataset(cart, basis, types, float(e.text), forces, stress,
                       f"{os.path.basename(xml_path)} step {i}")
        out.append(doc)
        if write:
            path = f"{out_prefix}{i}.json"
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w") as f:
                f.write(f"# Generated by fitsnap_tpu_torch vasp2json from "
                        f"{xml_path}\n")
                json.dump(doc, f, indent=2)
    return out


def vasprun_to_xyz(xml_path, xyz_path, sample_every=1):
    """vasprun.xml -> one extended-XYZ file the XYZ scraper consumes.

    Behavioral equivalent of the reference's `tools/xml2xyz.py` (frame
    layout `tools/xml2xyz.py:35-57`), with the stress converted from
    VASP's kB to the bar the metal-units XYZ path expects (the reference
    script passes the kB values through unconverted).
    """
    docs = vasprun_to_json(xml_path, "", write=False)
    kept = 0
    with open(xyz_path, "w") as f:
        for i, doc in enumerate(docs, start=1):
            if i % sample_every:
                continue
            d = doc["Dataset"]["Data"][0]
            lat = np.asarray(d["Lattice"], float).reshape(-1)
            line = ('Lattice = "' + " ".join(f"{x:.10g}" for x in lat)
                    + '" Properties=species:S:1:pos:R:3:forces:R:3 '
                    + f'energy={d["Energy"]:.10f}')
            # zero stress when the step has none (reference xml2xyz.py:47)
            s = np.asarray(d.get("Stress", np.zeros((3, 3))),
                           float).reshape(-1) * 1000.0
            line += ' stress="' + " ".join(f"{x:.6g}" for x in s) + '"'
            f.write(f'{d["NumAtoms"]}\n{line}\n')
            for t, p, fo in zip(d["AtomTypes"], d["Positions"], d["Forces"]):
                f.write(f"{t} " + " ".join(f"{x:.10g}" for x in p) + " "
                        + " ".join(f"{x:.10g}" for x in fo) + "\n")
            kept += 1
    return kept


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) not in (2, 3):
        print(__doc__)
        return 1
    src, dest = argv[0], argv[1]
    if dest.endswith(".xyz"):
        if not src.endswith(".xml"):
            print("XYZ output requires a vasprun.xml source "
                  "(OUTCAR -> XYZ is not supported; convert to JSON)")
            return 1
        n = vasprun_to_xyz(src, dest,
                           sample_every=int(argv[2]) if len(argv) == 3 else 1)
        print(f"wrote {n} XYZ frames to {dest}")
        return 0
    if len(argv) == 3:
        print(__doc__)
        return 1
    if src.endswith(".xml"):
        docs = vasprun_to_json(src, dest)
    else:
        docs = outcar_to_json(src, dest)
    print(f"wrote {len(docs)} JSON configs with prefix {dest}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
