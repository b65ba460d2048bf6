"""CUSTOM calculator: raw neighbor geometry for the pairwise NN
(reference `fitsnap3lib/calculators/lammps_custom.py`).

Copy of the host side of `fitsnap_tpu/calculators/custom.py`.  There is no
per-atom descriptor matrix here: the pairwise network computes its
Bessel / Gaussian 3-body descriptors inside the model (kernel K15), so this
calculator only packs padded displacement tensors, with the reverse table
of each neighbor list that the force gather reads (as
`calculators/snap.SnapCalculator.host_preprocess` builds it).
"""

import numpy as np

from fitsnap_tpu_torch.calculators.snap import (PackedConfig, _A_BUCKETS,
                                                _K_BUCKETS, _pad_to)
from fitsnap_tpu_torch.ops.neighbors import host_neighbors, reverse_neighbors
from fitsnap_tpu_torch.ops.refpot import parse_reference


class CustomCalculator:
    def __init__(self, name, config):
        self.config = config
        self.name = name
        sec = config.sections["CUSTOM"]
        self.sec = sec
        self.numtypes = sec.numtypes
        self.refspec = parse_reference(config.sections["REFERENCE"],
                                       sec.numtypes)
        # the neighbor lists reach the reference potential's cutoff too,
        # so pairs at r >= the custom cutoff occur (and contribute 0)
        self.cutoff = max(float(sec.cutoff), self.refspec.max_cutoff)
        self.type_mapping = sec.type_mapping

    def get_width(self):
        return self.sec.num_descriptors

    def _pack(self, data):
        types = np.array(
            [self.type_mapping[t] - 1 for t in data["AtomTypes"]], np.int32)
        return PackedConfig(
            pos=np.asarray(data["Positions"], np.float64),
            cell=np.asarray(data["Lattice"], np.float64),
            types=types, natoms=int(data["NumAtoms"]), data=data)

    def host_preprocess(self, data):
        """Pack configs and build their host neighbor lists, reverse
        tables and (a_pad, k_pad) shape buckets."""
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

    def process_configs(self, data, dtype=np.float64):
        raise NotImplementedError(
            "CUSTOM calculator is nonlinear-only (pairwise NN); use the "
            "NETWORK solver")
