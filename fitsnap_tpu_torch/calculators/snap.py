"""Batched SNAP linear-system assembly (PyTorch).

Counterpart of `fitsnap_tpu/calculators/snap.py`.  Neighbor lists and their
reverse tables are built on the host; configs are padded to (A, K) shapes,
grouped into shape buckets, and each chunk of a bucket goes through the rows
function as one batch of C configs on the device.  The rows function
(`snap_rows`, shared with the streamed fit of `parallel/fit.py`) is
`_rows_fn.one_config` of the JAX package with the config axis written out:
descriptors and their pair jacobian (kernels K1-K3), energy columns, force
and virial rows through the row-scatter kernel K4, and the reference
potential.

Row semantics (`calculators/lammps_snap.py:391-556` of the reference):
  energy row  = sum_i onehot(type_i) (x) desc_i / natoms   (x blank2J)
  force rows  = -d(sum_i desc_i)/dx_(n,c)                  (x blank2J)
  virial rows = -sum_pairs D_a dDesc/dD_b * 1.6021765e6 / vol
  b           = truth - reference potential value
"""

from dataclasses import dataclass

import numpy as np
import torch

from fitsnap_tpu_torch.kernels import snap_kernels as sk
from fitsnap_tpu_torch.ops.neighbors import host_neighbors, reverse_neighbors
from fitsnap_tpu_torch.ops.refpot import parse_reference, reference_eav
from fitsnap_tpu_torch.ops.snap import descriptors_with_jacobian, make_params
from fitsnap_tpu_torch.utils.torchsetup import DTYPE

TOBAR = 1.6021765e6

_A_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024)
_K_BUCKETS = (16, 32, 48, 64, 96, 128, 192, 256, 384, 512)


def _pad_to(x, buckets):
    for b in buckets:
        if x <= b:
            return b
    return ((int(x) + 127) // 128) * 128


def chunk_size(a_pad, k_pad, ncoeff):
    """Configs per device batch at one (A, K) shape: the per-pair jacobian
    G (A*K*ncoeff*3 doubles per config) stays near 256 MB, as in the JAX
    package, and at most 32 configs or 1024 atom slots go in one batch."""
    g_bytes = a_pad * k_pad * ncoeff * 3 * 8
    return int(min(32, max(1, 1024 // a_pad),
                   max(1, (1 << 30) // (4 * g_bytes))))


def pair_masks(params, disp, jidx, mask, types):
    """Neighbor elements (C, A, K) int32 and the SNAP pair mask: the pairs
    inside the per-element-pair SNAP cutoff (`mask` holds every pair inside
    the largest cutoff, the reference potential's too)."""
    C, A, K = mask.shape
    jelem = torch.gather(types, 1, jidx.long().reshape(C, A * K))
    jelem = jelem.reshape(C, A, K)
    rcutij = (params.radelem[types][:, :, None]
              + params.radelem[jelem]) * params.rcutfac
    r2 = torch.sum(disp * disp, -1)
    return jelem, mask & (r2 < rcutij * rcutij)


def snap_rows(params, numtypes, refspec, disp, jidx, mask, rev, types,
              natoms, cell, plain=False):
    """Energy columns, force/virial rows and reference values of a batch.

    The rows of `FitSnap` (`SnapCalculator.rows`) and of the streamed fit
    (`parallel/fit.py`).  disp (C, A, K, 3) f64; jidx, mask (C, A, K); rev
    (C, A, R) int32 reverse neighbor table (flat slots i*K + k); types
    (C, A) int32; natoms (C,); cell (C, 3, 3).  All on one device.
    `plain=True` runs the kernels' plain versions (the reference the kernels
    are checked against on the card).  blank2J is not applied here.
    """
    T = numtypes
    C, A, K = mask.shape
    dtp = disp.dtype
    jelem, smask = pair_masks(params, disp, jidx, mask, types)
    real = (torch.arange(A, device=disp.device)[None, :]
            < natoms[:, None]).to(dtp)

    B, G = descriptors_with_jacobian(
        disp.reshape(C * A, K, 3), jelem.reshape(C * A, K),
        smask.reshape(C * A, K), types.reshape(C * A), params, plain=plain)
    W0 = B.shape[1]
    B = B.reshape(C, A, W0) * real[..., None]
    G = G.reshape(C, A, W0, K, 3) * real[..., None, None, None]

    oh = torch.nn.functional.one_hot(types.long(), T).to(dtp) \
        * real[..., None]
    e_cols = torch.einsum("cat,caw->ctw", oh, B).reshape(C, T * W0)

    scatter = sk.pair_scatter_rows_plain if plain else sk.pair_scatter_rows
    force, vir = scatter(G, disp, smask, rev, types, T)
    force_rows = force.reshape(C, A, 3, T * W0)
    vol = cell[:, 0, 0] * cell[:, 1, 1] * cell[:, 2, 2]
    scale = (TOBAR / vol)[:, None]
    virial_rows = vir.reshape(C, 6, T * W0) * scale[..., None]

    re, rf, rv = reference_eav(disp, jidx, mask, rev, types, refspec,
                               plain=plain)
    return {"e_cols": e_cols, "force_rows": force_rows,
            "virial_rows": virial_rows,
            "ref_e": re, "ref_f": rf, "ref_v": rv * scale}


@dataclass
class PackedConfig:
    pos: np.ndarray
    cell: np.ndarray
    types: np.ndarray       # 0-based ints
    natoms: int
    data: dict
    disp: np.ndarray = None
    jidx: np.ndarray = None
    mask: np.ndarray = None
    rev: np.ndarray = None  # (natoms, R) reverse table, slots i*kcount + k
    kcount: int = 0


class SnapCalculator:
    """Builds the weighted linear system from scraped config dicts."""

    def __init__(self, name, config, device):
        self.config = config
        self.name = name
        self.device = torch.device(device)
        sec = config.sections["BISPECTRUM"]
        self.sec = sec
        self.type_mapping = sec.type_mapping
        self._fingerprint = None
        self._maybe_refresh()

    def _hyperparam_fingerprint(self):
        sec = self.sec

        def t(x):
            return tuple(np.ravel(np.asarray(x, float))) \
                if x is not None else None

        return (tuple(int(v) for v in np.atleast_1d(sec.twojmax)),
                sec.numtypes, t(sec.wj), t(sec.radelem), float(sec.rcutfac),
                float(sec.rfac0), float(sec.rmin0), bool(sec.chemflag),
                bool(sec.bnormflag), bool(sec.bzeroflag),
                bool(sec.wselfallflag), bool(sec.quadraticflag),
                bool(sec.switchflag), bool(sec.switchinnerflag),
                getattr(sec, "sinner", None), getattr(sec, "dinner", None),
                tuple(self.config.sections["REFERENCE"].lmp_pairdecl))

    def _maybe_refresh(self):
        """Rebuild the plan tables when section hyperparameters changed.

        Library-mode hyperparameter loops mutate `config.sections
        ['BISPECTRUM']` between fits; edits take effect on the next
        `process_configs`, as in the JAX package."""
        fp = self._hyperparam_fingerprint()
        if fp == self._fingerprint:
            return
        self._fingerprint = fp
        sec = self.sec
        self.params = make_params(sec, self.device)
        self.numtypes = sec.numtypes
        radelem = np.array([float(x) for x in sec.radelem])
        self.snap_cutoff = float(2.0 * radelem.max() * sec.rcutfac)
        self.refspec = parse_reference(self.config.sections["REFERENCE"],
                                       sec.numtypes)
        self.cutoff = max(self.snap_cutoff, self.refspec.max_cutoff)

    def get_width(self):
        sec = self.sec
        w = sec.ncoeff * sec.numtypes
        if not sec.bzeroflag:
            w += sec.numtypes
        return w

    # ---------------- packing ----------------

    def _pack(self, data: dict) -> PackedConfig:
        types = np.array(
            [self.type_mapping[t] - 1 for t in data["AtomTypes"]], np.int32)
        return PackedConfig(
            pos=np.asarray(data["Positions"], np.float64),
            cell=np.asarray(data["Lattice"], np.float64),
            types=types,
            natoms=int(data["NumAtoms"]),
            data=data,
        )

    def host_preprocess(self, data: list):
        """Pack configs and build host-side neighbor lists, their reverse
        tables and the shape buckets."""
        self._maybe_refresh()
        packed = [self._pack(d) for d in data]
        buckets = {}
        for idx, pc in enumerate(packed):
            disp, jidx, mask, kmax = host_neighbors(
                pc.pos, pc.cell, pc.natoms, self.cutoff)
            pc.disp, pc.jidx, pc.mask, pc.kcount = disp, jidx, mask, kmax
            pc.rev = reverse_neighbors(jidx, mask, pc.natoms)
            key = (_pad_to(pc.natoms, _A_BUCKETS), _pad_to(kmax, _K_BUCKETS))
            buckets.setdefault(key, []).append(idx)
        return packed, buckets

    # ---------------- device function ----------------

    def rows(self, disp, jidx, mask, rev, types, natoms, cell, plain=False):
        """`snap_rows` of a batch with this calculator's model."""
        return snap_rows(self.params, self.numtypes, self.refspec, disp,
                         jidx, mask, rev, types, natoms, cell, plain=plain)

    def process_single(self, data, plain=False):
        """Per-config rows (a, b, w) for library mode."""
        a, b, w, _ = self.process_configs([data], plain=plain)
        return a, b, w

    # ---------------- assembly ----------------

    def process_configs(self, data: list, plain=False):
        """Compute the full linear system at float64.

        Returns (a, b, w, fs_dict) where fs_dict carries the per-row
        bookkeeping lists the reference keeps in `pt.fitsnap_dict`.
        """
        packed, buckets = self.host_preprocess(data)
        results = [None] * len(packed)
        for ids, args in self.batches(packed, buckets):
            out = self.rows(*args, plain=plain)
            out = {k: v.cpu().numpy() for k, v in out.items()}
            for j, i in enumerate(ids):
                results[i] = {k: v[j] for k, v in out.items()}
        return self._assemble(packed, results)

    def batches(self, packed, buckets):
        """Yield (config indices, rows() arguments on the device) for every
        chunk of every shape bucket."""
        dev = self.device

        def put(x):
            return torch.from_numpy(x).to(dev)

        for (a_pad, k_pad), idxs in buckets.items():
            chunk = min(chunk_size(a_pad, k_pad, self.sec.ncoeff),
                        len(idxs))
            for c0 in range(0, len(idxs), chunk):
                ids = idxs[c0:c0 + chunk]
                n = len(ids)
                R = max(1, max(packed[i].rev.shape[1] for i in ids))
                disp = np.zeros((n, a_pad, k_pad, 3))
                jidx = np.zeros((n, a_pad, k_pad), np.int32)
                mask = np.zeros((n, a_pad, k_pad), bool)
                rev = np.full((n, a_pad, R), -1, np.int32)
                cell = np.zeros((n, 3, 3))
                types = np.zeros((n, a_pad), np.int32)
                nat = np.zeros((n,), np.int64)
                for j, i in enumerate(ids):
                    pc = packed[i]
                    na, kc = pc.natoms, pc.kcount
                    disp[j, :na, :kc] = pc.disp[:, :kc]
                    jidx[j, :na, :kc] = pc.jidx[:, :kc]
                    mask[j, :na, :kc] = pc.mask[:, :kc]
                    r = pc.rev
                    rev[j, :na, :r.shape[1]] = np.where(
                        r < 0, -1, (r // max(kc, 1)) * k_pad + r % max(kc, 1))
                    cell[j] = pc.cell
                    types[j, :na] = pc.types
                    nat[j] = na
                yield ids, (put(disp).to(DTYPE), put(jidx), put(mask),
                            put(rev), put(types), put(nat),
                            put(cell).to(DTYPE))

    def _assemble(self, packed, results):
        dtype = np.float64
        calc = self.config.sections["CALCULATOR"]
        sec = self.sec
        width = self.get_width()
        blank2j = np.asarray(sec.blank2J, dtype)
        total = 0
        for pc in packed:
            total += ((1 if calc.energy else 0)
                      + (3 * pc.natoms if calc.force else 0)
                      + (6 if calc.stress else 0))
        a = np.zeros((total, width), dtype)
        b = np.zeros((total,), dtype)
        w = np.zeros((total,), dtype)
        fs = {"Groups": [], "Configs": [], "Row_Type": [], "Atom_I": [],
              "Atom_Type": [], "Testing": []}

        def expand(block, counts_frac=None):
            """(..., raw_width) -> (..., width): insert per-type leading
            column when bzeroflag=0, apply blank2J (`lammps_snap.py:455`)."""
            if sec.bzeroflag:
                return block * blank2j
            shp = block.shape[:-1]
            blk = block.reshape(shp + (self.numtypes, sec.ncoeff))
            lead = np.zeros(shp + (self.numtypes, 1), dtype)
            if counts_frac is not None:
                lead = lead + counts_frac[..., None]
            out = np.concatenate([lead, blk], axis=-1)
            return out.reshape(shp + (width,)) * blank2j

        row = 0
        for pc, res in zip(packed, results):
            d = pc.data
            na = pc.natoms
            nr = 0
            if calc.energy:
                counts = np.bincount(pc.types, minlength=self.numtypes) / na
                a[row] = expand(res["e_cols"] / na, counts)
                b[row] = (d["Energy"] - res["ref_e"]) / na
                w[row] = d.get("eweight", 1.0)
                fs["Row_Type"].append("Energy")
                fs["Atom_I"].append(0)
                fs["Atom_Type"].append(0)
                row += 1
                nr += 1
            if calc.force:
                fr = expand(res["force_rows"][:na].reshape(3 * na, -1))
                a[row:row + 3 * na] = fr
                b[row:row + 3 * na] = (np.asarray(d["Forces"], dtype).ravel()
                                       - res["ref_f"][:na].ravel())
                w[row:row + 3 * na] = d.get("fweight", 1.0)
                fs["Row_Type"] += ["Force"] * (3 * na)
                fs["Atom_I"] += [i // 3 for i in range(3 * na)]
                fs["Atom_Type"] += [int(t) + 1 for t in pc.types
                                    for _ in range(3)]
                row += 3 * na
                nr += 3 * na
            if calc.stress:
                a[row:row + 6] = expand(res["virial_rows"])
                st = np.asarray(d["Stress"], dtype)
                b[row:row + 6] = st[[0, 1, 2, 1, 0, 0],
                                    [0, 1, 2, 2, 2, 1]] - res["ref_v"]
                w[row:row + 6] = d.get("vweight", 1.0)
                fs["Row_Type"] += ["Stress"] * 6
                fs["Atom_I"] += [0] * 6
                fs["Atom_Type"] += [0] * 6
                row += 6
                nr += 6
            fs["Groups"] += [d["Group"]] * nr
            fs["Configs"] += [d["File"]] * nr
            fs["Testing"] += [bool(d["test_bool"])] * nr
        return a, b, w, fs
