"""Batched ACE linear-system assembly (PyTorch).

Counterpart of `fitsnap_tpu/calculators/ace.py`.  Packing, host neighbor
lists with their reverse tables, shape buckets and device batches are the
SNAP calculator's; the rows function (`ace_rows`, shared with the streamed
fit of `parallel/fit.py`) runs the ACE descriptors and their pair jacobian
(kernels K13, K14), then the force and virial rows through the row-scatter
kernel K4 with one type block, and the reference potential (K5).  Labels
carry their central element (mu0), so the energy columns are the plain sum
over atoms and the width is the label count (+ one constant column per
element, leading, when bzeroflag = 0).

For the NN solver (nonlinear ACE, the reference's Ta_PACE_PyTorch_NN) the
calculator gives per-atom B and their pair jacobian G = dB/dD (K13, K14)
with the reference potential (K5) in the precompute mode (`nn_prep`), and
B and G of a minibatch in the OTF mode (`nn_descriptors`); it has no
pair-grid kit, so `dgrad_mode = cached` takes OTF.
"""

import numpy as np
import torch

from fitsnap_tpu_torch.calculators.snap import (TOBAR, PackedConfig,
                                                SnapCalculator)
from fitsnap_tpu_torch.kernels import snap_kernels as sk
from fitsnap_tpu_torch.ops.ace import (ace_descriptors_with_jacobian,
                                       build_ace_plan, plan_tensors)
from fitsnap_tpu_torch.ops.refpot import parse_reference, reference_eav


def _within_rcut(disp, jidx, types, plan, jtypes=None):
    """Neighbor elements (C, A, K) and the pair mask |r_ij| <
    rcut[type_i, type_j] (before the neighbor-list mask).  `jtypes` (C,
    A') are the types jidx indexes, where they are not `types`."""
    C, A, K = jidx.shape
    jtypes = types if jtypes is None else jtypes
    jelem = torch.gather(jtypes, 1, jidx.long().reshape(C, A * K))
    jelem = jelem.reshape(C, A, K)
    rcm = plan_tensors(plan, disp.device).rcut[types.long()[:, :, None],
                                               jelem.long()]
    r2 = torch.sum(disp * disp, -1)
    return jelem, r2 < rcm * rcm


def ace_batch(plan, disp, jidx, mask, types, natoms, plain=False,
              jtypes=None):
    """B (C, A, W) and dB/dD (C, A, W, K, 3) of a batch (K13, K14), zero on
    padded atoms and on pairs outside the bond cutoffs; with that pair mask
    (C, A, K).  Arguments as `ace_rows`'; `jtypes` as `_within_rcut`'s."""
    C, A, K = mask.shape
    jelem, inside = _within_rcut(disp, jidx, types, plan, jtypes)
    smask = mask & inside
    real = (torch.arange(A, device=disp.device)[None, :]
            < natoms[:, None]).to(disp.dtype)
    B, G = ace_descriptors_with_jacobian(
        disp.reshape(C * A, K, 3), jelem.reshape(C * A, K),
        smask.reshape(C * A, K), types.reshape(C * A), plan, plain=plain)
    W = B.shape[1]
    return (B.reshape(C, A, W) * real[..., None],
            G.reshape(C, A, W, K, 3) * real[..., None, None, None], smask)


def ace_rows(plan, refspec, disp, jidx, mask, rev, types, natoms, cell,
             plain=False, spins=None, charges=None):
    """Energy columns, force/virial rows and reference values of a batch.

    The rows of `FitSnap` (`AceCalculator.rows`) and of the streamed fit.
    Arguments as `calculators/snap.snap_rows`: disp (C, A, K, 3) f64; jidx,
    mask (C, A, K); rev (C, A, R) int32 reverse neighbor table; types
    (C, A) int32; natoms (C,); cell (C, 3, 3); spins and charges for the
    reference, or None.  `plain=True` runs the kernels' plain versions.
    Returns the same dict as `snap_rows`, with the label count as width.
    """
    C, A, K = mask.shape
    B, G, smask = ace_batch(plan, disp, jidx, mask, types, natoms, plain)
    W0 = B.shape[2]
    e_cols = B.sum(1)

    scatter = sk.pair_scatter_rows_plain if plain else sk.pair_scatter_rows
    force, vir = scatter(G, disp, smask, rev, torch.zeros_like(types), 1)
    vol = cell[:, 0, 0] * cell[:, 1, 1] * cell[:, 2, 2]
    scale = (TOBAR / vol)[:, None]
    re, rf, rv = reference_eav(disp, jidx, mask, rev, types, refspec,
                               plain=plain, spins=spins, charges=charges)
    return {"e_cols": e_cols, "force_rows": force.reshape(C, A, 3, W0),
            "virial_rows": vir.reshape(C, 6, W0) * scale[..., None],
            "ref_e": re, "ref_f": rf, "ref_v": rv * scale}


def nn_prep(plan, refspec, disp, jidx, mask, rev, types, natoms):
    """Per-atom descriptors B (C, A, W), their pair jacobian G (C, A, W, K,
    3), and the reference potential's energy (C,) and forces (C, A, 3) of a
    batch: the NN solver's precompute inputs (JAX `AceCalculator
    .nn_prep_fn`).  B and G come from K13 and K14, zero on padded atoms, G
    on every pair outside the bond cutoffs; then K5, with no spins or
    charges, as the JAX package's NN prep passes none.  Arguments as
    `ace_rows`'."""
    B, G, _ = ace_batch(plan, disp, jidx, mask, types, natoms)
    re, rf, _ = reference_eav(disp, jidx, mask, rev, types, refspec)
    return B, G, re, rf


class AceCalculator(SnapCalculator):
    """Builds the weighted ACE linear system from scraped config dicts."""

    # the JAX package's ACE rows pass the reference a spin array that
    # stays zero (`_pack` reads no Spins) and no charges
    REF_ARRAYS = {"spins": True, "charges": False}

    def __init__(self, name, config, device):
        self.config = config
        self.name = name
        self.device = torch.device(device)
        self.sec = config.sections["ACE"]
        self.type_mapping = self.sec.type_mapping
        self._fingerprint = None
        self._maybe_refresh()

    def _hyperparam_fingerprint(self):
        sec = self.sec
        return (sec.numtypes, tuple(sec.types), tuple(sec.ranks),
                tuple(sec.lmax), tuple(sec.nmax), int(sec.nmaxbase),
                tuple(sec.rcutfac), tuple(sec.lmbda), tuple(sec.rcinner),
                tuple(sec.drcinner), tuple(sec.lmin), bool(sec.bzeroflag),
                sec.b_basis, bool(sec.wigner_flag), tuple(sec.erefs),
                tuple(self.config.sections["REFERENCE"].lmp_pairdecl))

    def _maybe_refresh(self):
        """Rebuild the descriptor plan when section hyperparameters changed
        (library-mode loops edit `config.sections['ACE']` between fits)."""
        fp = self._hyperparam_fingerprint()
        if fp == self._fingerprint:
            return
        self._fingerprint = fp
        sec = self.sec
        self.plan = build_ace_plan(sec)
        self.numtypes = sec.numtypes
        self.refspec = parse_reference(self.config.sections["REFERENCE"],
                                       sec.numtypes)
        self.cutoff = max(float(np.max(self.plan.rcut)),
                          self.refspec.max_cutoff)
        # publish label metadata to the section (reference `ace.py:100-127`)
        sec.ncoeff = self.plan.ncoeff
        sec.blist = [[i] + list(map(list, lab[1:4]))
                     for i, lab in enumerate(self.plan.labels)]
        sec.blank2J = np.ones(len(self.plan.labels) + (
            0 if sec.bzeroflag else sec.numtypes))

    def desc_width(self):
        return len(self.plan.labels)

    def get_width(self):
        w = len(self.plan.labels)
        if not self.sec.bzeroflag:
            w += self.numtypes
        return w

    def _pack(self, data):
        """A config's arrays; no spins or charges (JAX `AceCalculator
        ._pack`)."""
        types = np.array(
            [self.type_mapping[t] - 1 for t in data["AtomTypes"]], np.int32)
        return PackedConfig(
            pos=np.asarray(data["Positions"], np.float64),
            cell=np.asarray(data["Lattice"], np.float64),
            types=types, natoms=int(data["NumAtoms"]), data=data)

    def rows(self, disp, jidx, mask, rev, types, natoms, cell, plain=False,
             spins=None, charges=None):
        """`ace_rows` of a batch with this calculator's plan."""
        return ace_rows(self.plan, self.refspec, disp, jidx, mask, rev,
                        types, natoms, cell, plain=plain, spins=spins,
                        charges=charges)

    def nn_prep(self, disp, jidx, mask, rev, types, natoms):
        """`nn_prep` of a batch with this calculator's plan."""
        return nn_prep(self.plan, self.refspec, disp, jidx, mask, rev, types,
                       natoms)

    def nn_descriptors(self, disp, jidx, mask, types, natoms):
        """B and G = dB/dD of a batch (K13, K14): the OTF mode's minibatch
        descriptors."""
        return ace_batch(self.plan, disp, jidx, mask, types, natoms)[:2]

    def nn_desc(self, disp, jidx, mask, types, natoms):
        """Per-atom descriptors B (C, A, W) of a batch, zero on padded atoms
        (JAX `AceCalculator.nn_desc_fn`): K14's B, its dB/dD dropped."""
        return self.nn_descriptors(disp, jidx, mask, types, natoms)[0]

    def nn_analytic(self):
        """None: the NN cached mode's pair-grid kit is SNAP's alone."""
        return None

    def nn_kit(self):
        raise NotImplementedError(
            "the NN pair-grid kit (K9-K11) is SNAP's: an ACE plan has "
            "none")

    def _expand(self, block, counts_frac=None):
        """(..., nlabels) -> (..., width): one leading constant column per
        element when bzeroflag = 0 (the atom fractions on energy rows)."""
        if self.sec.bzeroflag:
            return block
        lead = np.zeros(block.shape[:-1] + (self.numtypes,))
        if counts_frac is not None:
            lead = lead + counts_frac
        return np.concatenate([lead, block], axis=-1)
