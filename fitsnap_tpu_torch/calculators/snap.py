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

import os
from dataclasses import dataclass

import numpy as np
import torch

from fitsnap_tpu_torch.kernels import nn_kernels as nk
from fitsnap_tpu_torch.kernels import snap_kernels as sk
from fitsnap_tpu_torch.ops.neighbors import host_neighbors, reverse_neighbors
from fitsnap_tpu_torch.ops.refpot import parse_reference, reference_eav
from fitsnap_tpu_torch.ops.snap import (_quad_extend,
                                        descriptors_with_jacobian,
                                        make_params)

TOBAR = 1.6021765e6

_A_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024)
_K_BUCKETS = (16, 32, 48, 64, 96, 128, 192, 256, 384, 512)


def _pad_to(x, buckets):
    for b in buckets:
        if x <= b:
            return b
    return ((int(x) + 127) // 128) * 128


NN_PROGRAMS = 4   # shape buckets the NN solver coalesces a data set into


def coalesce_shape_buckets(buckets):
    """Merge (a_pad, k_pad) shape buckets into at most
    FITSNAP_TPU_NN_PROGRAMS (default NN_PROGRAMS, 4) covering shapes,
    greedily picking the merge that adds the least padded work
    (n * a_pad * k_pad proxy).

    The JAX package's function (`calculators/snap.py:47`) with its
    default cap, read as there: the buckets decide which configs share an
    NN minibatch, so the two packages must form the same index lists.
    Returns the same {(a_pad, k_pad): [config indices]} mapping.
    """
    max_programs = int(os.environ.get("FITSNAP_TPU_NN_PROGRAMS",
                                      str(NN_PROGRAMS)))
    items = [{"a": a, "k": k, "idxs": list(v)}
             for (a, k), v in sorted(buckets.items())]

    def cost(it, a=None, k=None):
        return len(it["idxs"]) * (a or it["a"]) * (k or it["k"])

    while len(items) > max_programs:
        best = None
        for i, s in enumerate(items):
            for j, d in enumerate(items):
                if i == j:
                    continue
                a, k = max(s["a"], d["a"]), max(s["k"], d["k"])
                added = cost(s, a, k) + cost(d, a, k) - cost(s) - cost(d)
                if best is None or added < best[0]:
                    best = (added, i, j, a, k)
        _, i, j, a, k = best
        items[j] = {"a": a, "k": k, "idxs": items[j]["idxs"] + items[i]["idxs"]}
        del items[i]
    return {(it["a"], it["k"]): it["idxs"] for it in items}


def chunk_size(a_pad, k_pad, ncoeff):
    """Configs per device batch at one (A, K) shape: the per-pair jacobian
    G (A*K*ncoeff*3 doubles per config) stays near 256 MB, as in the JAX
    package, and at most 32 configs or 1024 atom slots go in one batch."""
    g_bytes = a_pad * k_pad * ncoeff * 3 * 8
    return int(min(32, max(1, 1024 // a_pad),
                   max(1, (1 << 30) // (4 * g_bytes))))


def pair_masks(params, disp, jidx, mask, types, jtypes=None):
    """Neighbor elements (C, A, K) int32 and the SNAP pair mask: the pairs
    inside the per-element-pair SNAP cutoff (`mask` holds every pair inside
    the largest cutoff, the reference potential's too).  `jtypes` (C, A')
    are the types jidx indexes, where they are not `types` (a block of a
    config's atoms with global jidx)."""
    C, A, K = mask.shape
    params = params.cast(disp.dtype)
    jtypes = types if jtypes is None else jtypes
    jelem = torch.gather(jtypes, 1, jidx.long().reshape(C, A * K))
    jelem = jelem.reshape(C, A, K)
    rcutij = (params.radelem[types][:, :, None]
              + params.radelem[jelem]) * params.rcutfac
    r2 = torch.sum(disp * disp, -1)
    return jelem, mask & (r2 < rcutij * rcutij)


def _batch_descriptors(params, disp, jidx, mask, types, natoms, plain,
                       jtypes=None):
    """B (C, A, W) and dB/dD (C, A, W, K, 3) of a batch, zero on padded
    atoms and on pairs outside the SNAP mask; with that mask (C, A, K) and
    the real-atom mask (C, A) as floats.  `jtypes` as for `pair_masks`.
    Everything is at disp's type, float64 or float32 (the plan's tables
    at that type, `SnapParams.cast`)."""
    C, A, K = mask.shape
    params = params.cast(disp.dtype)
    jelem, smask = pair_masks(params, disp, jidx, mask, types, jtypes)
    real = (torch.arange(A, device=disp.device)[None, :]
            < natoms[:, None]).to(disp.dtype)
    B, G = descriptors_with_jacobian(
        disp.reshape(C * A, K, 3), jelem.reshape(C * A, K),
        smask.reshape(C * A, K), types.reshape(C * A), params, plain=plain)
    W = B.shape[1]
    return (B.reshape(C, A, W) * real[..., None],
            G.reshape(C, A, W, K, 3) * real[..., None, None, None], smask,
            real)


def snap_rows(params, numtypes, refspec, disp, jidx, mask, rev, types,
              natoms, cell, plain=False, spins=None, charges=None):
    """Energy columns, force/virial rows and reference values of a batch.

    The rows of `FitSnap` (`SnapCalculator.rows`) and of the streamed fit
    (`parallel/fit.py`).  disp (C, A, K, 3) f64 or f32 (every row and
    reference value at its type, the cell's too); jidx, mask (C, A, K); rev
    (C, A, R) int32 reverse neighbor table (flat slots i*K + k); types
    (C, A) int32; natoms (C,); cell (C, 3, 3); spins (C, A, 3) and charges
    (C, A) for the reference potential, or None (`ref_arrays`).  All on one
    device.  `plain=True` runs the kernels' plain versions (the reference
    the kernels are checked against on the card).  blank2J is not applied
    here.
    """
    T = numtypes
    C, A, K = mask.shape
    B, G, smask, real = _batch_descriptors(params, disp, jidx, mask, types,
                                           natoms, plain)
    W0 = B.shape[2]
    oh = torch.nn.functional.one_hot(types.long(), T).to(disp.dtype) \
        * real[..., None]
    e_cols = torch.einsum("cat,caw->ctw", oh, B).reshape(C, T * W0)

    scatter = sk.pair_scatter_rows_plain if plain else sk.pair_scatter_rows
    force, vir = scatter(G, disp, smask, rev, types, T)
    force_rows = force.reshape(C, A, 3, T * W0)
    vol = cell[:, 0, 0] * cell[:, 1, 1] * cell[:, 2, 2]
    scale = (TOBAR / vol)[:, None]
    virial_rows = vir.reshape(C, 6, T * W0) * scale[..., None]

    re, rf, rv = reference_eav(disp, jidx, mask, rev, types, refspec,
                               plain=plain, spins=spins, charges=charges)
    return {"e_cols": e_cols, "force_rows": force_rows,
            "virial_rows": virial_rows,
            "ref_e": re, "ref_f": rf, "ref_v": rv * scale}


def nn_prep(params, refspec, disp, jidx, mask, rev, types, natoms):
    """Per-atom descriptors B (C, A, W), their pair jacobian G (C, A, W, K,
    3), and the reference potential's energy (C,) and forces (C, A, 3) of a
    batch: the NN solver's training inputs.

    The JAX package's `SnapCalculator.nn_prep_fn` with the config axis
    written out: the SNAP pair mask, then K1-K3 (their chemflag modes, and
    K6q under quadraticflag), then the reference potential (K5).  B and
    G are zero on padded atoms, and G on every pair outside the SNAP mask,
    so the force contraction may run over all neighbor slots.  Arguments as
    `snap_rows`'; the reference gets no spins or charges, as in the JAX
    package's NN prep."""
    B, G, _, _ = _batch_descriptors(params, disp, jidx, mask, types, natoms,
                                    plain=False)
    re, rf, _ = reference_eav(disp, jidx, mask, rev, types, refspec)
    return B, G, re, rf


def nn_analytic(params):
    """The NN cached mode's kit (JAX `SnapCalculator.nn_analytic_fns`), or
    None for chemflag and quadraticflag, which it does not cover: `nn_kit`
    where the cached mode applies."""
    if params.chemflag or params.quadraticflag:
        return None
    return nn_kit(params)


def nn_kit(params):
    """The pair-grid kit of one element channel on the base descriptors:
    the cached mode's, and the OTF mode's for linear SNAP and, with the
    quadratic columns' chain rule applied by the caller, quadraticflag.
    Batches carry the config axis C first, as `snap_rows`'.  Roles:

      utb(disp, jidx, mask, types, natoms) -> (ut (C, A, 2U), B (C, A, W)):
          the cached per-atom state, K9 (B zero on padded atoms);
      dEdu_vg(dEdB (M, W), ut (M, 2U)) -> vg (M, n_t, n_t): the grid
          cotangent of M atoms, K2 then K10;
      pair(disp, jidx, mask, types) -> (jelem, smask) (C, A, K): what the
          pair kernels need of a config (the grid tensors themselves are
          never stored);
      force(vg (C*A, n_t, n_t), disp, pair, types) -> dE/ddisp (C, A, K,
          3): K11.

    Each role computes at its float inputs' type, float64 or float32, on
    the plan at that type (`SnapParams.cast`).
    """
    def pair(disp, jidx, mask, types):
        return pair_masks(params, disp, jidx, mask, types)

    def flat(disp, pair_, types):
        C, A, K = pair_[0].shape
        return (disp.reshape(C * A, K, 3), pair_[0].reshape(C * A, K),
                pair_[1].reshape(C * A, K), types.reshape(C * A))

    def utb(disp, jidx, mask, types, natoms):
        C, A, _ = mask.shape
        ut, B = nk.nn_ut_b(*flat(disp, pair(disp, jidx, mask, types), types),
                           params.cast(disp.dtype))
        real = (torch.arange(A, device=disp.device)[None, :]
                < natoms[:, None]).to(B.dtype)
        return ut.reshape(C, A, -1), B.reshape(C, A, -1) * real[..., None]

    def dEdu_vg(dEdB, ut):
        p = params.cast(dEdB.dtype)
        return nk.nn_dedu_vg(dEdB, *sk.zlist(ut, p), p)

    def force(vg, disp, pair_, types):
        return nk.nn_pair_force(vg, *flat(disp, pair_, types),
                                params.cast(vg.dtype)).reshape(disp.shape)

    return {"utb": utb, "dEdu_vg": dEdu_vg, "pair": pair, "force": force}


def nn_desc(params, disp, jidx, mask, types, natoms):
    """Per-atom descriptors B (C, A, W) of a batch, zero on padded atoms:
    JAX `SnapCalculator.nn_desc_fn` on the pair grid (K9's B, over the
    element channels under chemflag, with the quadratic columns appended
    under quadraticflag), at disp's type (the plan at that type)."""
    C, A, K = mask.shape
    params = params.cast(disp.dtype)
    jelem, smask = pair_masks(params, disp, jidx, mask, types)
    _, B = nk.nn_ut_b(disp.reshape(C * A, K, 3), jelem.reshape(C * A, K),
                      smask.reshape(C * A, K), types.reshape(C * A), params)
    real = (torch.arange(A, device=disp.device)[None, :]
            < natoms[:, None]).to(B.dtype)
    return _quad_extend(B, params).reshape(C, A, -1) * real[..., None]


def pack_bucket(packed, ids, a_pad, k_pad):
    """Host arrays of configs `ids` padded to (a_pad, k_pad): disp (n, A, K,
    3) f64, jidx (n, A, K) i32, mask (n, A, K), rev (n, A, R) i32 (slots
    remapped to a*k_pad + k, R the largest in-degree, at least 1), cell
    (n, 3, 3) f64, types (n, A) i32, natoms (n,) i64: the arguments of
    `snap_rows` and `nn_prep`, in their order."""
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
    return disp, jidx, mask, rev, types, nat, cell


def ref_arrays(packed, ids, a_pad, refspec, spins=True, charges=True):
    """{"spins": (n, a_pad, 3), "charges": (n, a_pad)} host arrays of
    configs `ids` for the reference potential, zero on padded atoms and on
    configs without the key; None where the reference has no spin term or
    no coul/cut (or where the caller passes none: `spins`, `charges`
    False)."""
    n = len(ids)
    out = {"spins": None, "charges": None}
    if spins and refspec.spin is not None:
        out["spins"] = np.zeros((n, a_pad, 3))
    if charges and refspec.coul is not None:
        out["charges"] = np.zeros((n, a_pad))
    for key in ("spins", "charges"):
        if out[key] is None:
            continue
        for j, i in enumerate(ids):
            x = getattr(packed[i], key)
            if x is not None:
                out[key][j, :packed[i].natoms] = x
    return out


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
    spins: np.ndarray = None   # (natoms, 3) unit vectors, or None
    charges: np.ndarray = None  # (natoms,) per-atom charges, or None


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

    def desc_width(self):
        """Descriptor columns per atom (the width of B and dB/dD)."""
        return self.sec.ncoeff

    def get_width(self):
        sec = self.sec
        w = sec.ncoeff * sec.numtypes
        if not sec.bzeroflag:
            w += sec.numtypes
        return w

    # ---------------- packing ----------------

    def _pack(self, data: dict) -> PackedConfig:
        """A config's arrays, with its unit spins (`Spins` columns 1:4,
        normalized) where the reference has a spin term and its charges
        where it has coul/cut, which needs them (JAX `_pack`)."""
        types = np.array(
            [self.type_mapping[t] - 1 for t in data["AtomTypes"]], np.int32)
        spins = None
        if "Spins" in data and self.refspec.spin is not None:
            vec = np.asarray(data["Spins"], np.float64)[:, 1:4]
            spins = vec / np.linalg.norm(vec, axis=1)[:, None]
        charges = None
        if self.refspec.coul is not None:
            if "Charges" not in data:
                raise ValueError(
                    "REFERENCE pair_style coul/cut needs per-atom charges "
                    f"(atom_style charge), but config {data.get('File')} "
                    "has no 'Charges' key")
            charges = np.asarray(data["Charges"], np.float64).reshape(-1)
        return PackedConfig(
            pos=np.asarray(data["Positions"], np.float64),
            cell=np.asarray(data["Lattice"], np.float64),
            types=types,
            natoms=int(data["NumAtoms"]),
            data=data,
            spins=spins,
            charges=charges,
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

    def rows(self, disp, jidx, mask, rev, types, natoms, cell, plain=False,
             spins=None, charges=None):
        """`snap_rows` of a batch with this calculator's model."""
        return snap_rows(self.params, self.numtypes, self.refspec, disp,
                         jidx, mask, rev, types, natoms, cell, plain=plain,
                         spins=spins, charges=charges)

    def nn_prep(self, disp, jidx, mask, rev, types, natoms):
        """`nn_prep` of a batch with this calculator's model."""
        return nn_prep(self.params, self.refspec, disp, jidx, mask, rev,
                       types, natoms)

    def nn_descriptors(self, disp, jidx, mask, types, natoms):
        """B and G = dB/dD of a batch (K1-K3 and their chemflag modes, K6q
        under quadraticflag), zero on padded atoms: the OTF mode's
        minibatch descriptors under chemflag."""
        return _batch_descriptors(self.params, disp, jidx, mask, types,
                                  natoms, plain=False)[:2]

    def nn_analytic(self):
        """`nn_analytic` of this calculator's model (None where the cached
        mode does not apply)."""
        self._maybe_refresh()
        return nn_analytic(self.params)

    def nn_kit(self):
        """`nn_kit` of this calculator's model."""
        self._maybe_refresh()
        return nn_kit(self.params)

    def nn_desc(self, disp, jidx, mask, types, natoms):
        """`nn_desc` of a batch with this calculator's model."""
        return nn_desc(self.params, disp, jidx, mask, types, natoms)

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
            out = self.rows(*args, plain=plain,
                            **self.ref_tensors(packed, ids, args[0]))
            out = {k: v.cpu().numpy() for k, v in out.items()}
            for j, i in enumerate(ids):
                results[i] = {k: v[j] for k, v in out.items()}
        return self._assemble(packed, results)

    # what the rows pass the reference (JAX `process_configs`: the SNAP
    # rows both arrays, the ACE rows a spin array that stays zero)
    REF_ARRAYS = {"spins": True, "charges": True}

    def batches(self, packed, buckets):
        """Yield (config indices, rows() arguments on the device) for every
        chunk of every shape bucket."""
        dev = self.device
        for (a_pad, k_pad), idxs in buckets.items():
            chunk = min(chunk_size(a_pad, k_pad, self.desc_width()),
                        len(idxs))
            for c0 in range(0, len(idxs), chunk):
                ids = idxs[c0:c0 + chunk]
                arrays = pack_bucket(packed, ids, a_pad, k_pad)
                yield ids, tuple(torch.from_numpy(x).to(dev)
                                 for x in arrays)

    def ref_tensors(self, packed, ids, disp):
        """rows()' keyword arguments of the reference for the batch of
        configs `ids` whose disp is `disp` (its device and atom slots):
        `ref_arrays` as tensors, or None."""
        ref = ref_arrays(packed, ids, disp.shape[1], self.refspec,
                         **self.REF_ARRAYS)
        return {k: None if v is None else torch.from_numpy(v).to(disp.device)
                for k, v in ref.items()}

    def _expand(self, block, counts_frac=None):
        """(..., raw_width) -> (..., width): insert per-type leading column
        when bzeroflag=0, apply blank2J (`lammps_snap.py:455`)."""
        sec = self.sec
        blank2j = np.asarray(sec.blank2J, np.float64)
        if sec.bzeroflag:
            return block * blank2j
        shp = block.shape[:-1]
        blk = block.reshape(shp + (self.numtypes, sec.ncoeff))
        lead = np.zeros(shp + (self.numtypes, 1))
        if counts_frac is not None:
            lead = lead + counts_frac[..., None]
        out = np.concatenate([lead, blk], axis=-1)
        return out.reshape(shp + (self.get_width(),)) * blank2j

    def _assemble(self, packed, results):
        dtype = np.float64
        calc = self.config.sections["CALCULATOR"]
        width = self.get_width()
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

        expand = self._expand
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
