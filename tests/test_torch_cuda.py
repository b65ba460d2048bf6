"""The CUDA kernels K1-K5, K6q, K7, K8, K8r, K9-K11 (with K10T and K11T),
K12, K12T, K13 and K14 (and the chemflag modes of K1-K3) against their
plain versions on the card.

Needs an NVIDIA GPU and nvcc (the kernels are built at first use); skipped
elsewhere.  The machine with the card has no JAX, which the suite's
conftest imports, so run this file on its own there:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Cases: twojmax 6 with one element, and twojmax 4 with two elements,
bzeroflag and the inner switching function; blocks with masked pairs, a
padded atom and an atom that is its own neighbor through a periodic image.
K5, K7, K8 and K8r run on one batch of three configs built on the card by
K8: a 2-atom cell whose atoms meet their own images, a 5-atom cell with a
padded atom, and a padded config (natoms 0); K5 (the whole ZBL reference,
`zbl_eav`) also on the cases of tests/test_torch_zbl.py (two types,
one-sided lists, atoms that meet their own images, a type pair without
coefficients, padding atoms) and on 40 configs, bit for bit from run to
run; its ref_eav mode (coul/cut, the spin term with and without its
offset, zbl + coul/cut + spin) on four of those cases with seeded charges
and unit spins.  K8 also at its edges
(`K8_CASES`: a triclinic cell, a 2-atom cell at S = 343, a perfect bcc
supercell of ties, truncation, an empty config, padded atoms and rows, an
atom that meets its own image, the sizes it refused before its bins (768
atoms at S = 27, 160 at S = 125), its pruned buffer in shared memory and in
global scratch, and six of them in its split shape): mask and jidx equal,
disp within 1e-12, bit for bit from run to run.  K12 at its edges
(`K12_CASES`: W = 30, 55 and 31 with 3K = 192, 120 and 123, K = 200, one
atom, the (8, 64) bucket, G off a 16-byte boundary): 1e-11, one launch each
of the contraction and the gather, bit for bit from run to run.  K8r also on seeded lists
with destinations repeated within rows, a truncated table (rows past the
width, entries dropped and counted), 37 atoms of 13 slots, 2 configs of
600 atoms x 128 slots and one of 5,000 atoms x 8 slots, each twice, bit
for bit.  Tolerance: 1e-11 relative to
the largest magnitude of each output (the kernels sum in another order
than the plain versions, at float64); K8's mask and jidx and K8r's table
exactly.  K13 and K14 run on 12 atoms x 40 neighbor slots for a
one-element plan (ranks 1-4, lmax up to 2) and a two-element plan with an
inner cutoff on the mixed bonds, with masked pairs, pairs past the cutoff
and an empty atom; K13 also at lmax 8 and on the two-element plan in four
convention pairs (radial pace_px, pace_mx, v0_t1, pace_x; Ylm 4pi, std,
racah) on 12 atoms x 37 slots, bit for bit from run to run, and with
spline radials (delta 0.001) on both of those plans; K7 also in the ACE layout (two leading constant
columns), and at the widths its output is tiled over (480 and 1,596, both
layouts, direct and residual, with a padded and a one-atom config), bit for
bit from run to run.  K4 with one to three source types at widths 1, 4,
37 (not a multiple of its x-tile) and 600, bit for bit from run to run.
quadraticflag and chemflag: K1-K3 with K3 in four W tiles and K6q at
twojmax 8; K1-K3 past K1's former caps, at twojmax 10, 13, 14 and 16
(K1's recursion shape, K3's level shape), with five chemflag channels at
twojmax 2 and InP's two at twojmax 12 (J and dB/dD of masked slots and z
outputs without terms exactly 0, bit for bit from run to run, and
`descriptors_with_jacobian` against its plain path); K1's recursion shape
forced at twojmax 6 and 12 and with two channels at 4 and 12 (the same
bits at one level split as at the planner's), K3's level shape forced at
twojmax 6 and 8 with K = 13, 40, 64 and 200 (its slot tiles), and K3's
slab shape forced at twojmax 6 and 8 and with two channels at 4, bit for
bit its whole-row shape; the chemflag modes of
K1-K3 with two elements at twojmax 4
(wselfallflag 0 and 1, bnormflag) and, with K6q, quadratic x chemflag at
twojmax 2.  K3 at the edges of its tiles (W = 5 and 55, K = 13, 19, 21,
37, three channels, every neighbor in one channel, neighbors of no
channel, an atom with every slot masked) and K14 where an element's labels
need several tiles (the InP_PACE shape, K = 21, atoms whose element is out
of range): padding slots exactly 0, bit for bit from run to run.  K9 in
its element-channel mode (two channels at twojmax 4, 6 and 8, three at 2
and 4; wselfallflag 0 and 1; 200 slots; an atom whose other channels are
empty), bit for bit, with K10, K10T, K11 and K11T refusing channels, and
two channels at twojmax 14 refused for their shared memory.  K12
and K12T on two small periodic cells with a padded atom (and twice, to
show a run repeats bit for bit), and the gradient of a
force loss with respect to MLP parameters through `NnForce` against
autograd through K12's plain version, 1e-10.  K9, K10, K10T, K11, K11T and
the force gather on two configs of 6 atoms x 40 slots (the two CASES
plans; a self image, masked pairs, a padded atom), each once and bit for
bit from run to run; the force-loss gradient through `NnCachedForce`
against autograd through the plain versions, 1e-10.  The force gather at
its edges (rows of 3 x 41 doubles, an atom no one neighbors, R = 1, R = 60
> 32 and > K, 640 atoms) and K11T at twojmax 6, 8, 10, 12, 13, 14, 15 and
16 (two blocks an atom from 15), with 200
slots (more than one round of prologues), 640 atoms and 2 atoms, a masked
hole before live slots and a masked-in pair past the SNAP cutoff, each
once, bit for bit from run to run (K11T: the padded atom's grid exactly
0); K11, K10T, K10 and K9 on the same cases (K11: every slot that is not
live, masked or past the cutoff or of the padded atom, exactly 0; K10T
and K10 on both launch shapes, the z entries staged up to twojmax 8 and
read from L2 from 10, and on an odd atom count, whose last block holds
one atom; K9 also at twojmax 16, the padded atom's ut exactly the self
term and its B the twin's).
K15, K15V and K15T
(the custom pairwise NN's descriptors, their VJP and its transpose, also
through the force gather's transpose) on two periodic cells with pairs
past the cutoff and on the radial ramp and live slots masked mid-row, on
4 atoms of 512 slots, on one slot per atom, on the two cells with 1, 2 and
6 Gaussian columns (the edges of the kernels' Gaussian recurrence)
and on a minibatch shaped like the pairwise set's (8, 64) bucket (4 x 8
atoms x 64 slots, about 58 live); all three also in their wide launch
shape (more atoms than SMs: 160 atoms of 512 slots, 4 x 64 atoms of 64
slots, with 23, 1 and 2 columns): dead slots exactly 0, bit for bit from
run to run; the loss gradient through `PairDescForce` against double
autograd through the plain descriptors, 1e-10.
The float32 instantiations of the streamed linear SNAP fit (`-k f32`):
K1-K3 at twojmax 4, 6, 10 and 12, K8 and K8r on the K8 batch's hi/lo
float32 parts in both launch shapes, on 30 atoms at 40-50 A coordinates
(also within 1e-6 A of the float64 host lists) and on twelve of K8's
edges (both buffers pruned, the split shape), K4 at widths
1, 30 and 31, K5 and K7 (direct and residual) on the K8 batch: 1e-5
relative (float32 sums in other orders), K8's mask and jidx and K8r's
table exactly, K8's disp within 2 ulp, every output float32 (K7's direct
mode float64); and the float32 refusals of the modes without a float32
kernel (the chemflag modes, K6q, ref_eav, K4's halo) with their ROADMAP.md
queue item, and of float16 and mixed float inputs.  The float32
instantiations of the NN solver's cached and OTF modes (`-k "f32_k9 or
f32_gather or f32_nn"`): K9, K10, K10T, K11, K11T and the force gather at
twojmax 4 (two elements), 6, 8 and 12 against their float32 plain
versions, 1e-4, launched once each as "<name>_f32", bit for bit from run
to run; the gather with float4 and single-float row loads; the loss
gradient through NnCachedForce at float32 (1e-4); and the refusals at
twojmax 13, with element channels, and of K12 and K12T at float32.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fitsnap_tpu_torch.kernels import ace_kernels as ak
from fitsnap_tpu_torch.kernels import snap_kernels as sk
from fitsnap_tpu_torch.ops.ace import build_ace_plan, slot_table
from fitsnap_tpu_torch.ops.neighbors import (count_neighbors, host_neighbors,
                                             required_shifts,
                                             reverse_neighbors, shift_table)
from fitsnap_tpu_torch.ops.refpot import build_zbl, zbl_table
from fitsnap_tpu_torch.ops.snap import make_params

pytestmark = pytest.mark.cuda

RTOL = 1e-11
CASES = {
    "tj6": dict(twojmax=["6"], numtypes=1, wj=["1.0"], radelem=["0.5"],
                bzeroflag=0, switchinnerflag=0),
    "tj4_two_elements": dict(twojmax=["4", "4"], numtypes=2,
                             wj=["1.0", "0.7"], radelem=["0.5", "0.42"],
                             bzeroflag=1, switchinnerflag=1,
                             sinner="1.3 1.5", dinner="0.4 0.5"),
}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


_PARAMS = {}


def shared_params(spec, device):
    """make_params of a case's section, built once a run (a twojmax 16
    plan takes about a minute of host time)."""
    key = (repr(sorted(spec.items())), str(device))
    if key not in _PARAMS:
        _PARAMS[key] = make_params(section(spec), device)
    return _PARAMS[key]


def section(spec):
    base = dict(rcutfac=4.67637, rfac0=0.99363, rmin0=0.0, chemflag=0,
                quadraticflag=0, bnormflag=0, wselfallflag=0, switchflag=1,
                sinner=None, dinner=None)
    return SimpleNamespace(**dict(base, **spec))


def rel_err(out, ref):
    return max((o - r).abs().max().item() / max(r.abs().max().item(), 1e-300)
               for o, r in zip(out, ref))


@pytest.mark.parametrize("name", sorted(CASES))
def test_k1_k3_match_plain(cuda, name):
    spec = CASES[name]
    p = make_params(section(spec), cuda)
    N, K = 16, 40
    rng = np.random.default_rng(4)
    d = rng.normal(size=(N, K, 3))
    d *= rng.uniform(1.2, 4.9, (N, K, 1)) / np.linalg.norm(d, axis=-1,
                                                          keepdims=True)
    d[0, 1] = [3.3, 0.0, 0.0]
    mask = rng.uniform(size=(N, K)) < 0.85
    mask[-1] = False
    nel = spec["numtypes"]
    args = (torch.as_tensor(d, device=cuda),
            torch.as_tensor(rng.integers(0, nel, (N, K)), dtype=torch.int32,
                            device=cuda),
            torch.as_tensor(mask, device=cuda),
            torch.as_tensor(rng.integers(0, nel, N), dtype=torch.int32,
                            device=cuda))
    sk.reset_launches()
    k1 = sk.pair_u_duals(*args, p)
    ref1 = sk.pair_u_duals_plain(*args, p)
    J, ut = ref1
    k2 = sk.zlist(ut, p)
    ref2 = sk.zlist_plain(ut, p)
    k3 = sk.dbdd(ut, *ref2, J, p)
    ref3 = sk.dbdd_plain(ut, *ref2, J, p)
    torch.cuda.synchronize()
    assert {k: v for k, v in sk.launches().items() if v} == {
        "pair_u_duals": 1, "zlist": 1, "dbdd": 1}
    for out, ref in ((k1, ref1), (k2, ref2), (k3, ref3)):
        assert rel_err(out, ref) <= RTOL


FLAG_CASES = {
    "quadratic_tj8": dict(twojmax=["8"], numtypes=1, wj=["1.0"],
                          radelem=["0.5"], bzeroflag=0, switchinnerflag=0,
                          quadraticflag=1),
    "chem_tj4_wself0": dict(twojmax=["4", "4"], numtypes=2,
                            wj=["1.0", "0.93"], radelem=["0.5", "0.45"],
                            bzeroflag=1, switchinnerflag=0, chemflag=1,
                            bnormflag=1),
    "chem_tj4_wself1": dict(twojmax=["4", "4"], numtypes=2,
                            wj=["1.0", "0.93"], radelem=["0.5", "0.45"],
                            bzeroflag=1, switchinnerflag=0, chemflag=1,
                            bnormflag=1, wselfallflag=1),
    "quadratic_chem_tj2": dict(twojmax=["2", "2"], numtypes=2,
                               wj=["1.0", "0.93"], radelem=["0.5", "0.45"],
                               bzeroflag=1, switchinnerflag=0, chemflag=1,
                               quadraticflag=1),
}


@pytest.mark.parametrize("name", sorted(FLAG_CASES))
def test_flag_kernels_match_plain(cuda, name):
    """The kernels of the quadratic and chemflag paths on one block of 12
    atoms x 40 slots, each against its plain version on the same inputs."""
    spec = FLAG_CASES[name]
    p = make_params(section(spec), cuda)
    N, K = 12, 40
    rng = np.random.default_rng(8)
    d = rng.normal(size=(N, K, 3))
    d *= rng.uniform(1.2, 4.9, (N, K, 1)) / np.linalg.norm(d, axis=-1,
                                                          keepdims=True)
    mask = rng.uniform(size=(N, K)) < 0.85
    mask[-1] = False
    nel = spec["numtypes"]
    args = (torch.as_tensor(d, device=cuda),
            torch.as_tensor(rng.integers(0, nel, (N, K)), dtype=torch.int32,
                            device=cuda),
            torch.as_tensor(mask, device=cuda),
            torch.as_tensor(rng.integers(0, nel, N), dtype=torch.int32,
                            device=cuda))
    chem = p.nchem > 1
    sk.reset_launches()
    k1 = (sk.pair_u_duals_chem if chem else sk.pair_u_duals)(*args, p)
    ref1 = sk.pair_u_duals_plain(*args, p)
    J, ut = ref1
    if chem:
        k2 = sk.zlist_chem(ut, p)
        ref2 = sk.zlist_chem_plain(ut, p)
        k3 = sk.dbdd_chem(ut, *ref2, J, args[1], p)
        ref3 = sk.dbdd_chem_plain(ut, *ref2, J, args[1], p)
    else:
        k2 = sk.zlist(ut, p)
        ref2 = sk.zlist_plain(ut, p)
        k3 = sk.dbdd(ut, *ref2, J, p)
        ref3 = sk.dbdd_plain(ut, *ref2, J, p)
    pairs = [(k1, ref1), (k2, ref2), (k3, ref3)]
    if p.quadraticflag:
        pairs.append((sk.quad_chain(*ref3, p), sk.quad_chain_plain(*ref3, p)))
    torch.cuda.synchronize()
    suffix = "_chem" if chem else ""
    want = {f"pair_u_duals{suffix}": 1, f"zlist{suffix}": 1,
            f"dbdd{suffix}": 1}
    if p.quadraticflag:
        want["quad_chain"] = 1
    assert {k: v for k, v in sk.launches().items() if v} == want
    if name == "quadratic_tj8":
        assert sk.dbdd_tiles(p, K) == (16, 4)
    for out, ref in pairs:
        assert rel_err(out, ref) <= RTOL


# K1's lifted caps: 2U = 1,012 columns (twojmax 10, several splits), five
# element channels, twojmax 13, 14 and 16 (K1's recursion shape, K3's level
# shape) and InP's two channels at twojmax 12 (K1's recursion shape)
TJ10 = dict(twojmax=["10"], numtypes=1, wj=["1.0"], radelem=["0.5"],
            bzeroflag=1, switchinnerflag=0)
CAP_CASES = {
    "tj10": TJ10,
    "tj13": dict(CASES["tj6"], twojmax=["13"]),
    "tj14": dict(CASES["tj6"], twojmax=["14"]),
    "tj16": dict(CASES["tj6"], twojmax=["16"]),
    "chem2_tj12": dict(twojmax=["12", "12"], numtypes=2, wj=["1.0", "0.93"],
                       radelem=["0.5", "0.45"], bzeroflag=1,
                       switchinnerflag=0, chemflag=1, wselfallflag=1),
    "chem5_tj2": dict(twojmax=["2"] * 5, numtypes=5,
                      wj=["1.0", "0.93", "0.8", "0.75", "0.6"],
                      radelem=["0.5", "0.45", "0.4", "0.48", "0.42"],
                      bzeroflag=1, switchinnerflag=0, chemflag=1),
}


@pytest.mark.parametrize("name", sorted(CAP_CASES))
def test_k1_caps_lifted_match_plain(cuda, name):
    """K1, K2 and K3 beyond K1's old caps (twojmax 10 and 13-16; five
    channels; two at twojmax 12) on 12 atoms x 40 slots, each against its
    plain version on the same inputs; J and dB/dD of masked slots and z
    outputs without terms exactly 0, a second run bit for bit, and
    `descriptors_with_jacobian` against `plain=True`."""
    from fitsnap_tpu_torch.ops.snap import descriptors_with_jacobian

    spec = CAP_CASES[name]
    p = shared_params(spec, cuda)
    N, K, nel = 12, 40, spec["numtypes"]
    rng = np.random.default_rng(12)
    d = rng.normal(size=(N, K, 3))
    d *= rng.uniform(1.2, 4.4, (N, K, 1)) / np.linalg.norm(d, axis=-1,
                                                          keepdims=True)
    mask = rng.uniform(size=(N, K)) < 0.85
    mask[-1] = False
    args = (torch.as_tensor(d, device=cuda),
            torch.as_tensor(rng.integers(0, nel, (N, K)), dtype=torch.int32,
                            device=cuda),
            torch.as_tensor(mask, device=cuda),
            torch.as_tensor(rng.integers(0, nel, N), dtype=torch.int32,
                            device=cuda))
    chem = p.nchem > 1
    k1w = sk.pair_u_duals_chem if chem else sk.pair_u_duals
    k2w = sk.zlist_chem if chem else sk.zlist
    sk.reset_launches()
    k1 = [k1w(*args, p) for _ in range(2)]
    ref1 = sk.pair_u_duals_plain(*args, p)
    J, ut = ref1
    k2 = [k2w(ut, p) for _ in range(2)]
    ref2 = (sk.zlist_chem_plain if chem else sk.zlist_plain)(ut, p)
    if chem:
        k3 = [sk.dbdd_chem(ut, *ref2, J, args[1], p) for _ in range(2)]
        ref3 = sk.dbdd_chem_plain(ut, *ref2, J, args[1], p)
    else:
        k3 = [sk.dbdd(ut, *ref2, J, p) for _ in range(2)]
        ref3 = sk.dbdd_plain(ut, *ref2, J, p)
    torch.cuda.synchronize()
    suffix = "_chem" if chem else ""
    assert {k: v for k, v in sk.launches().items() if v} == {
        f"pair_u_duals{suffix}": 2, f"zlist{suffix}": 2, f"dbdd{suffix}": 2}
    for out, ref in ((k1[0], ref1), (k2[0], ref2), (k3[0], ref3)):
        assert rel_err(out, ref) <= RTOL
    for outs in (k1, k2, k3):
        assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert (k1[0][0].permute(1, 2, 0, 3)[~args[2]] == 0).all()
    assert (k3[0][1].permute(0, 2, 1, 3)[~args[2]] == 0).all()
    zero = sk.zlist_tables(p).zo.long()
    assert all((z.reshape(N, -1, p.nz)[..., zero] == 0).all() for z in k2[0])
    out = descriptors_with_jacobian(*args, p)
    ref = descriptors_with_jacobian(*args, p, plain=True)
    assert rel_err(out, ref) <= RTOL


def cap_block(p, nel, device, N=12, K=40, seed=12):
    """K1's inputs on N atoms x K slots (masked pairs, a padded atom)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(N, K, 3))
    d *= rng.uniform(1.2, 4.4, (N, K, 1)) / np.linalg.norm(d, axis=-1,
                                                          keepdims=True)
    mask = rng.uniform(size=(N, K)) < 0.85
    mask[-1] = False
    return (torch.as_tensor(d, device=device),
            torch.as_tensor(rng.integers(0, nel, (N, K)), dtype=torch.int32,
                            device=device),
            torch.as_tensor(mask, device=device),
            torch.as_tensor(rng.integers(0, nel, N), dtype=torch.int32,
                            device=device))


# K1's recursion shape forced where its planner takes the window (twojmax
# 6, InP's two channels at 4) and where it takes the recursion itself
# (twojmax 12, two channels at 12), and K3's slab shape forced where it
# takes whole rows (twojmax 6 and 8, two channels at 4)
FORCED_CASES = {
    "tj6": CASES["tj6"],
    "tj8": dict(CASES["tj6"], twojmax=["8"]),
    "tj12": dict(CASES["tj6"], twojmax=["12"]),
    "chem2_tj4": dict(CAP_CASES["chem2_tj12"], twojmax=["4", "4"]),
    "chem2_tj12": CAP_CASES["chem2_tj12"],
}


@pytest.mark.parametrize("name", ["tj6", "tj8", "chem2_tj4"])
def test_k3_slab_shape_equals_whole_rows(cuda, monkeypatch, name):
    """K3 in its slab shape (forced: rows of 32, slabs of 48 columns) equals
    its whole-row shape bit for bit (the same chains of tensor-core steps),
    and its plain version to 1e-11; dB/dD of masked slots exactly 0."""
    spec = FORCED_CASES[name]
    p = shared_params(spec, cuda)
    args = cap_block(p, spec["numtypes"], cuda)
    chem = p.nchem > 1
    J, ut = sk.pair_u_duals_plain(*args, p)
    z = (sk.zlist_chem_plain if chem else sk.zlist_plain)(ut, p)

    def k3():
        if chem:
            return sk.dbdd_chem(ut, *z, J, args[1], p)
        return sk.dbdd(ut, *z, J, p)

    whole = k3()
    tiles = -(-p.nb_base // 32)
    monkeypatch.setattr(sk, "dbdd_plan", lambda p, K=64: (32, tiles, 48))
    monkeypatch.setattr(sk, "K3_SHAPES", ("slab",))
    slab = k3()
    torch.cuda.synchronize()
    ref = (sk.dbdd_chem_plain(ut, *z, J, args[1], p) if chem
           else sk.dbdd_plain(ut, *z, J, p))
    assert rel_err(slab, ref) <= RTOL
    assert all(torch.equal(a, b) for a, b in zip(slab, whole))
    assert (slab[1].permute(0, 2, 1, 3)[~args[2]] == 0).all()


@pytest.mark.parametrize("name", ["tj6", "tj12", "chem2_tj4", "chem2_tj12"])
def test_k1_recursion_shape_matches_plain(cuda, monkeypatch, name):
    """K1 in its recursion shape (forced) against its plain version on 12
    atoms x 40 slots, launched once a call; J of masked slots exactly 0, a
    second run bit for bit, and the same bits at one level split as at
    the planner's."""
    spec = FORCED_CASES[name]
    p = shared_params(spec, cuda)
    args = cap_block(p, spec["numtypes"], cuda)
    monkeypatch.setattr(sk, "K1_SHAPES", ("recursion",))
    k1w = sk.pair_u_duals_chem if p.nchem > 1 else sk.pair_u_duals
    sk.reset_launches()
    out = [k1w(*args, p) for _ in range(2)]
    torch.cuda.synchronize()
    assert sk.launches()[k1w.__name__] == 2
    shape, nsplit = sk.pair_u_plan(p, 12, 40, 132)
    assert shape == "recursion" and nsplit > 1
    assert rel_err(out[0], sk.pair_u_duals_plain(*args, p)) <= RTOL
    assert all(torch.equal(a, b) for a, b in zip(*out))
    assert (out[0][0].permute(1, 2, 0, 3)[~args[2]] == 0).all()
    monkeypatch.setattr(sk, "K1_RECUR_SPLITS", 1)
    one = k1w(*args, p)
    assert all(torch.equal(a, b) for a, b in zip(one, out[0]))


# K3's level shape forced at slot tiles of every kind: (section, K): one
# tile of 13 slots (39 columns), two of 20 (K = 40), two of 32 (K = 64:
# two n-tiles for some warps) and seven of 29 (K = 200)
LEVEL_CASES = {
    "tj6_K13": (CASES["tj6"], 13),
    "tj8_K40": (FORCED_CASES["tj8"], 40),
    "tj6_K64": (CASES["tj6"], 64),
    "tj6_K200": (CASES["tj6"], 200),
}


@pytest.mark.parametrize("name", sorted(LEVEL_CASES))
def test_k3_level_shape_matches_plain(cuda, monkeypatch, name):
    """K3 in its level shape (forced) against its plain version to 1e-11 on
    12 atoms x K slots; dB/dD of masked slots exactly 0; a second run bit
    for bit."""
    spec, K = LEVEL_CASES[name]
    p = shared_params(spec, cuda)
    args = cap_block(p, 1, cuda, K=K)
    J, ut = sk.pair_u_duals_plain(*args, p)
    z = sk.zlist_plain(ut, p)
    monkeypatch.setattr(sk, "dbdd_shape", lambda p, K=64: "level")
    sk.reset_launches()
    out = [sk.dbdd(ut, *z, J, p) for _ in range(2)]
    torch.cuda.synchronize()
    assert sk.launches()["dbdd"] == 2
    assert rel_err(out[0], sk.dbdd_plain(ut, *z, J, p)) <= RTOL
    assert all(torch.equal(a, b) for a, b in zip(*out))
    assert (out[0][1].permute(0, 2, 1, 3)[~args[2]] == 0).all()


# K3's tile edges: (section, K, neighbor elements): W = 5 (twojmax 2, one
# row tile of 16) and 55 (twojmax 8, four tiles of 16), K not a multiple of
# 8, three channels (W = 135, five tiles), every neighbor in one channel,
# and neighbors whose element is no channel ("none": -1 and 2 of two)
K3_EDGES = {
    "tj2_K13": (dict(twojmax=["2"], numtypes=1, wj=["1.0"],
                     radelem=["0.5"], bzeroflag=0, switchinnerflag=0), 13,
                "random"),
    "tj8_K37": (FLAG_CASES["quadratic_tj8"], 37, "random"),
    "chem3_tj2_K21": (dict(twojmax=["2"] * 3, numtypes=3,
                           wj=["1.0", "0.93", "0.8"],
                           radelem=["0.5", "0.45", "0.4"], bzeroflag=1,
                           switchinnerflag=0, chemflag=1), 21, "random"),
    "chem_tj4_one_channel": (FLAG_CASES["chem_tj4_wself1"], 24, "ones"),
    "chem_tj4_none": (FLAG_CASES["chem_tj4_wself0"], 19, "none"),
}


@pytest.mark.parametrize("name", sorted(K3_EDGES))
def test_k3_tile_edges_match_plain(cuda, name):
    """K3 at the edges of its tiles against its plain version: 7 atoms, the
    last with every slot masked; padding slots and neighbors of no channel
    exactly 0, and a second run bit for bit."""
    spec, K, kind = K3_EDGES[name]
    p = make_params(section(spec), cuda)
    N, nel = 7, spec["numtypes"]
    rng = np.random.default_rng(11)
    d = rng.normal(size=(N, K, 3))
    d *= rng.uniform(1.2, 4.9, (N, K, 1)) / np.linalg.norm(d, axis=-1,
                                                          keepdims=True)
    mask = rng.uniform(size=(N, K)) < 0.8
    mask[-1] = False
    jel = rng.integers(0, nel, (N, K))
    if kind == "ones":
        jel[:] = 1
    dev = [torch.as_tensor(x, device=cuda) for x in (d, mask)]
    args = (dev[0], torch.as_tensor(jel, dtype=torch.int32, device=cuda),
            dev[1], torch.as_tensor(rng.integers(0, nel, N),
                                    dtype=torch.int32, device=cuda))
    J, ut = sk.pair_u_duals_plain(*args, p)
    chem = p.nchem > 1
    z = (sk.zlist_chem_plain if chem else sk.zlist_plain)(ut, p)
    jelem = args[1]
    if kind == "none":
        jelem = jelem.clone()
        jelem[:, ::5] = -1
        jelem[:, 1::7] = 2
    sk.reset_launches()
    if chem:
        outs = [sk.dbdd_chem(ut, *z, J, jelem, p) for _ in range(2)]
        ref = sk.dbdd_chem_plain(ut, *z, J, jelem, p)
    else:
        outs = [sk.dbdd(ut, *z, J, p) for _ in range(2)]
        ref = sk.dbdd_plain(ut, *z, J, p)
    torch.cuda.synchronize()
    assert sum(sk.launches().values()) == 2
    assert rel_err(outs[0], ref) <= RTOL
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    G = outs[0][1]
    assert (G.permute(0, 2, 1, 3)[~args[2]] == 0).all()
    if kind == "none":
        dead = (jelem < 0) | (jelem >= p.nchem)
        assert dead.any() and (G.permute(0, 2, 1, 3)[dead] == 0).all()
    if kind == "ones":
        assert ref[1].abs().max() > 0


# the InP_PACE shape (two elements of 172 labels, several label tiles of
# K14) with an inner cutoff on the In-P bond
ACE_INP = dict(numtypes=2, ranks=[1, 2, 3, 4], lmax=[1, 2, 2, 1],
               nmax=[22, 3, 2, 1], lmin=[0, 0, 1, 1], nmaxbase=22,
               rcutfac=[5.5] * 4, lmbda=[3.0] * 4,
               rcinner=[0.0, 2.4, 2.4, 0.0],
               drcinner=[0.01, 0.5, 0.5, 0.01])


def test_k14_tile_edges_match_plain(cuda):
    """K14 against its plain version where the labels of an element need
    several tiles, at K = 21 (not a multiple of 8), with atoms whose element
    is out of range (-1, 2: all outputs exactly 0) and an atom with every
    slot masked; a second run bit for bit."""
    plan = build_ace_plan(SimpleNamespace(b_basis="minsub", **ACE_INP))
    N, K = 9, 21
    assert ak.ace_b_dbdd_tiles(plan)[1] > 1
    rng = np.random.default_rng(12)
    d = rng.normal(size=(N, K, 3))
    d *= rng.uniform(1.5, 5.4, (N, K, 1)) / np.linalg.norm(d, axis=-1,
                                                          keepdims=True)
    mask = rng.uniform(size=(N, K)) < 0.85
    mask[-1] = False
    ielem = rng.integers(0, 2, N)
    args = (torch.as_tensor(d, device=cuda),
            torch.as_tensor(rng.integers(0, 2, (N, K)), dtype=torch.int32,
                            device=cuda),
            torch.as_tensor(mask, device=cuda),
            torch.as_tensor(ielem, dtype=torch.int32, device=cuda))
    A, Jp = ak.ace_pair_basis_plain(*args, plan)
    ielem[[1, 4]] = [-1, 2]
    ie = torch.as_tensor(ielem, dtype=torch.int32, device=cuda)
    ak.reset_launches()
    outs = [ak.ace_b_dbdd(A, Jp, ie, plan) for _ in range(2)]
    ref = ak.ace_b_dbdd_plain(A, Jp, ie, plan)
    torch.cuda.synchronize()
    assert ak.launches()["ace_b_dbdd"] == 2
    assert rel_err(outs[0], ref) <= RTOL
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    B, G = outs[0]
    assert (B[[1, 4]] == 0).all() and (G[[1, 4]] == 0).all()
    assert (G.permute(0, 2, 1, 3)[~args[2]] == 0).all()
    assert ref[1][0].abs().max() > 0


# (full width, layout, constant columns, types): the InP chemflag width
# (480, no constant columns), the quadratic SNAP width (1,596: 1,595 raw and
# one constant column), and the ACE layout at both widths
K7_WIDE = {"inp480_snap": (480, "snap", False, 2),
           "w480_ace": (480, "ace", True, 2),
           "quad1596_snap": (1596, "snap", True, 1),
           "w1596_ace": (1596, "ace", True, 3)}


def k7_batch(device, W, const_cols, T, seed=5):
    """Rows of four configs of 5 atom slots: full, padded (natoms 0), one
    atom, and one padded atom slot; random rows, truths and weights."""
    rng = np.random.default_rng(seed)
    C, A = 4, 5
    Wr = W - (T if const_cols else 0)

    def dev(*shape):
        return torch.as_tensor(rng.normal(size=shape), device=device)

    rows = {"e_cols": dev(C, Wr), "force_rows": dev(C, A, 3, Wr),
            "virial_rows": dev(C, 6, Wr), "ref_e": dev(C),
            "ref_f": dev(C, A, 3), "ref_v": dev(C, 6)}
    truths = (dev(C), dev(C, A, 3), dev(C, 6))
    weights = (dev(C).abs(), dev(C).abs(), dev(C).abs())
    natoms = torch.as_tensor([A, 0, 1, A - 1], dtype=torch.int32,
                             device=device)
    types = torch.as_tensor(rng.integers(0, T, (C, A)), dtype=torch.int32,
                            device=device)
    return rows, truths, weights, natoms, types, dev(W)


@pytest.mark.parametrize("mode", ["direct", "residual"])
@pytest.mark.parametrize("name", sorted(K7_WIDE))
def test_k7_wide_rows_match_plain(cuda, name, mode):
    """K7 at the widths one block cannot hold whole (its output tiled over
    column blocks), both layouts, direct and residual, with a padded and a
    one-atom config; two launches give the same bits."""
    W, layout, const_cols, T = K7_WIDE[name]
    rows, truths, weights, natoms, types, coeff = k7_batch(
        cuda, W, const_cols, T)
    c = coeff if mode == "residual" else None
    args = (rows, truths, weights, natoms, types, T, const_cols,
            {"energy": 1, "force": 1, "stress": 1}, c, c is None, layout)
    sk.reset_launches()
    out = sk.normal_contrib(*args)
    again = sk.normal_contrib(*args)
    ref = sk.normal_contrib_plain(*args)
    torch.cuda.synchronize()
    assert sk.launches()["normal_contrib"] == 2
    assert out[0].shape == (W, W) and out[1].shape == (W,)
    assert rel_err(out[1:2], ref[1:2]) <= RTOL
    if c is None:
        assert rel_err(out[:1], ref[:1]) <= RTOL
    else:
        assert not out[0].any()
    assert out[2].item() == ref[2].item()
    assert all(torch.equal(x, y) for x, y in zip(out, again))


# (feature columns X, types T): the SNAP and ZBL widths with one to three
# source types, a width that is not a multiple of K4's x-tile, and a wide one
K4_CASES = {"x4_t2": (4, 2), "x1_t1": (1, 1), "x1_t3": (1, 3),
            "x37_t3": (37, 3), "x600_t1": (600, 1), "x600_t2": (600, 2)}


@pytest.mark.parametrize("name", sorted(K4_CASES))
def test_k4_matches_plain(cuda, name):
    """Row scatter over real neighbor lists of two small periodic cells
    (self images repeated in the reverse table), with one to three source
    types; two launches give the same bits."""
    X, T = K4_CASES[name]
    rng = np.random.default_rng(3)
    cfgs = []
    for na, edge in ((2, 3.3), (5, 5.0)):
        pos = rng.uniform(0, edge, (na, 3))
        disp, jidx, mask, kmax = host_neighbors(pos, np.eye(3) * edge, na,
                                                4.8)
        cfgs.append((disp, jidx, mask, kmax,
                     reverse_neighbors(jidx, mask, na), na))
    C, A = 2, 6
    K = max(c[3] for c in cfgs)
    R = max(c[4].shape[1] for c in cfgs)
    disp = np.zeros((C, A, K, 3))
    msk = np.zeros((C, A, K), bool)
    rev = np.full((C, A, R), -1, np.int32)
    types = np.zeros((C, A), np.int32)
    for c, (dsp, _, m, km, rv, na) in enumerate(cfgs):
        disp[c, :na, :km] = dsp
        msk[c, :na, :km] = m
        rev[c, :na, :rv.shape[1]] = np.where(rv < 0, -1,
                                             rv // km * K + rv % km)
        types[c, :na] = rng.integers(0, T, na)
    # atom 0 of the small cell is its own neighbor through several images
    assert ((rev[0, 0] >= 0) & (rev[0, 0] // K == 0)).sum() >= 2
    g = rng.normal(size=(C, A, X, K, 3)) * msk[:, :, None, :, None]
    args = [torch.as_tensor(x, device=cuda)
            for x in (g, disp, msk, rev, types)]
    sk.reset_launches()
    out = sk.pair_scatter_rows(*args, T)
    again = sk.pair_scatter_rows(*args, T)
    ref = sk.pair_scatter_rows_plain(*args, T)
    torch.cuda.synchronize()
    assert sk.launches()["pair_scatter_rows"] == 2
    assert rel_err(out, ref) <= RTOL
    assert all(torch.equal(x, y) for x, y in zip(out, again))
    gathers, none = sk.pair_scatter_rows(*args, T, gather_only=True)
    want, _ = sk.pair_scatter_rows_plain(*args, T, gather_only=True)
    assert none is None and rel_err([gathers], [want]) <= RTOL


def launched(module):
    """{kernel: launches} of a wrapper module, the kernels launched only."""
    return {k: v for k, v in module.launches().items() if v}


def nn_batch(device):
    """A K12 minibatch: two small periodic cells (self images repeated in
    the reverse table) and a padded atom, G zero off the listed pairs."""
    rng = np.random.default_rng(9)
    cfgs = []
    for na, edge in ((2, 3.3), (5, 5.0)):
        pos = rng.uniform(0, edge, (na, 3))
        _, jidx, mask, kmax = host_neighbors(pos, np.eye(3) * edge, na, 4.8)
        cfgs.append((jidx, mask, kmax, reverse_neighbors(jidx, mask, na),
                     na))
    N, A, W = 2, 6, 7
    K = max(c[2] for c in cfgs)
    R = max(c[3].shape[1] for c in cfgs)
    jidx = np.zeros((N, A, K), np.int32)
    msk = np.zeros((N, A, K), bool)
    rev = np.full((N, A, R), -1, np.int32)
    for c, (ji, m, km, rv, na) in enumerate(cfgs):
        jidx[c, :na, :km] = ji
        msk[c, :na, :km] = m
        rev[c, :na, :rv.shape[1]] = np.where(rv < 0, -1,
                                             rv // km * K + rv % km)
    G = rng.normal(size=(N, A, W, K, 3)) * msk[:, :, None, :, None]
    return [torch.as_tensor(x, device=device)
            for x in (rng.normal(size=(N, A, W)), G, jidx, rev,
                      rng.normal(size=(N, A, 3)))]


def test_k12_k12t_match_plain(cuda):
    from fitsnap_tpu_torch.kernels import nn_kernels as nk

    dEdB, G, jidx, rev, gF = nn_batch(cuda)
    nk.reset_launches()
    out = nk.nn_force(dEdB, G, jidx, rev)
    out_t = nk.nn_force_t(gF, G, jidx)
    torch.cuda.synchronize()
    assert launched(nk) == {"nn_force": 1, "nn_pair_gather": 1,
                            "nn_force_t": 1}
    assert rel_err([out], [nk.nn_force_plain(dEdB, G, jidx, rev)]) <= RTOL
    assert rel_err([out_t], [nk.nn_force_t_plain(gF, G, jidx)]) <= RTOL
    # a run repeats bit for bit (fixed-order sums, no atomics)
    assert torch.equal(out, nk.nn_force(dEdB, G, jidx, rev))
    assert torch.equal(out_t, nk.nn_force_t(gF, G, jidx))


# K12 at its edges: (N, A, W, K).  W = 30 and 55 with K = 64 and 40 (3K
# even: 16-byte loads); W = 31 with K = 41 (3K and W x 3K odd: 8-byte
# loads); K = 200 (3K = 600: four column chunks, the last one short); a
# one-atom minibatch; the (8, 64) bucket of the NN sets (4 x 8 atoms);
# "unaligned": G 8 bytes off a 16-byte boundary (8-byte loads with 3K
# even).
K12_CASES = {"w30_k64": (4, 16, 30, 64), "w55_k40": (2, 8, 55, 40),
             "w31_k41": (2, 7, 31, 41), "k200": (2, 4, 30, 200),
             "one_atom": (1, 1, 30, 64), "bucket_8x64": (4, 8, 30, 64),
             "unaligned": (2, 6, 30, 64)}


def k12_block(name, device):
    """dE/dB (N, A, W), G (N, A, W, K, 3), jidx (N, A, K) and the reverse
    table rev of seeded lists with masked slots; G is seeded on every slot
    (the gather sums each atom's own slots, listed or not, and scatters the
    listed ones), so a one-atom minibatch's forces do not cancel."""
    N, A, W, K = K12_CASES[name]
    rng = np.random.default_rng(30)
    jidx = rng.integers(0, A, (N, A, K)).astype(np.int32)
    mask = rng.uniform(size=(N, A, K)) < 0.8
    G = rng.normal(size=(N, A, W, K, 3))
    jt = torch.as_tensor(jidx, device=device)
    rev, _ = sk.reverse_table_plain(jt, torch.as_tensor(mask, device=device))
    Gt = torch.as_tensor(G, device=device)
    if name == "unaligned":
        flat = torch.empty(G.size + 1, dtype=torch.float64, device=device)
        flat[1:] = Gt.reshape(-1)
        Gt = flat[1:].view(G.shape)
        assert Gt.is_contiguous() and Gt.data_ptr() % 16 == 8
    return (torch.as_tensor(rng.normal(size=(N, A, W)), device=device), Gt,
            jt, rev)


@pytest.mark.parametrize("name", list(K12_CASES))
def test_k12_shapes_match_plain(cuda, name):
    """K12 (its contraction, then the gather) against its plain version,
    one launch of each, bit for bit from run to run."""
    from fitsnap_tpu_torch.kernels import nn_kernels as nk

    dEdB, G, jidx, rev = k12_block(name, cuda)
    nk.reset_launches()
    out = nk.nn_force(dEdB, G, jidx, rev)
    torch.cuda.synchronize()
    assert launched(nk) == {"nn_force": 1, "nn_pair_gather": 1}
    assert rel_err([out], [nk.nn_force_plain(dEdB, G, jidx, rev)]) <= RTOL
    assert torch.equal(out, nk.nn_force(dEdB, G, jidx, rev))


def test_nn_force_gradient_matches_plain_autograd(cuda):
    """The gradient of a force loss with respect to MLP parameters, through
    NnForce (K12, backward K12T) and through autograd of the plain K12."""
    from fitsnap_tpu_torch.kernels import nn_kernels as nk
    from fitsnap_tpu_torch.models.mlp import atom_energies

    _, G, jidx, rev, target = nn_batch(cuda)
    N, A, W = G.shape[:3]
    rng = np.random.default_rng(10)
    x0 = torch.as_tensor(rng.normal(size=(N, A, W)), device=cuda)
    params = [(torch.as_tensor(rng.normal(size=(1, a, b)) / np.sqrt(a),
                               device=cuda).requires_grad_(True),
               torch.as_tensor(rng.normal(size=(1, b)), device=cuda)
               .requires_grad_(True))
              for a, b in ((W, 5), (5, 1))]
    leaves = [t for wb in params for t in wb]

    def grads(force):
        x = x0.clone().requires_grad_(True)
        e = atom_energies(params, x, torch.zeros((N, A), dtype=torch.int32,
                                                 device=cuda)).sum()
        dedx, = torch.autograd.grad(e, x, create_graph=True)
        loss = ((force(dedx) - target) ** 2).sum() + e ** 2
        return torch.autograd.grad(loss, leaves)

    nk.reset_launches()
    out = grads(lambda d: nk.NnForce.apply(d, G, jidx, rev))
    torch.cuda.synchronize()
    assert launched(nk) == {"nn_force": 1, "nn_pair_gather": 1,
                            "nn_force_t": 1}
    ref = grads(lambda d: nk.nn_force_plain(d, G, jidx, rev))
    assert rel_err(out, ref) <= 1e-10


def grid_block(spec, device, nconf=2, A=6, K=40):
    """Inputs of the pair-grid kernels K9-K11: nconf configs of A atoms x K
    neighbor slots, flat (nconf*A, K) as K1's (a self image, masked pairs,
    a padded atom), with neighbor indices jidx (nconf, A, K) inside each
    config and their reverse table rev (nconf, A, R)."""
    p = shared_params(spec, device)
    N = nconf * A
    rng = np.random.default_rng(12)
    d = rng.normal(size=(N, K, 3))
    d *= rng.uniform(1.2, 4.9, (N, K, 1)) / np.linalg.norm(d, axis=-1,
                                                          keepdims=True)
    d[0, 1] = [3.3, 0.0, 0.0]
    mask = rng.uniform(size=(N, K)) < 0.85
    mask[-1] = False
    nel = spec["numtypes"]
    jidx = rng.integers(0, A, (nconf, A, K))
    slots = [[np.flatnonzero((jidx[c] == m).ravel() & mask.reshape(
        nconf, A * K)[c]) for m in range(A)] for c in range(nconf)]
    R = max(len(x) for row in slots for x in row)
    rev = np.full((nconf, A, R), -1)
    for c, row in enumerate(slots):
        for m, x in enumerate(row):
            rev[c, m, :len(x)] = x

    def t(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=device)

    block = (t(d), t(rng.integers(0, nel, (N, K)), torch.int32), t(mask),
             t(rng.integers(0, nel, N), torch.int32))
    return p, block, t(jidx, torch.int32), t(rev, torch.int32)


# K9's element-channel mode (chemflag): two elements at twojmax 4
# (wselfallflag 0 and 1, bnormflag) and three at twojmax 2
CHEM_CASES = {
    "tj4_chem2": dict(CASES["tj4_two_elements"], chemflag=1, bnormflag=1),
    "tj4_chem2_wself": dict(CASES["tj4_two_elements"], chemflag=1,
                            wselfallflag=1, switchinnerflag=0),
    "tj2_chem3": dict(twojmax=["2"] * 3, numtypes=3, wj=["1.0", "0.8", "0.7"],
                      radelem=["0.5", "0.45", "0.42"], bzeroflag=1,
                      switchinnerflag=0, chemflag=1),
}


def self_ut(p, ie):
    """The ut (2 nchem U,) of an atom of element ie without neighbors: the
    self term in every channel (wselfallflag, or one channel), else in its
    own, real parts channel-major, then imaginary parts."""
    U, nc = p.u_len, p.nchem
    own = torch.ones(nc, dtype=torch.float64, device=p.selfvec.device)
    if nc > 1 and not p.wselfallflag:
        own = torch.nn.functional.one_hot(torch.tensor(ie), nc).to(own)
    ut = (own[:, None] * p.selfvec[None]).reshape(nc, 2, U)
    return torch.cat([ut[:, 0].reshape(-1), ut[:, 1].reshape(-1)])


@pytest.mark.parametrize("name", sorted(CASES) + sorted(CHEM_CASES))
def test_k9_k10_k11_match_plain(cuda, name):
    """K9, K10, K10T, K11, K11T and the force gather against their plain
    versions, each launched once, and bit for bit from run to run.  Under
    chemflag K9 alone, in its element-channel mode; K10, K10T, K11 and
    K11T refuse element channels loudly."""
    from fitsnap_tpu_torch.kernels import nn_kernels as nk
    from fitsnap_tpu_torch.ops.snap import nn_tables

    if name in CHEM_CASES:
        p, block, jidx, _ = grid_block(CHEM_CASES[name], cuda)
        assert p.nchem == CHEM_CASES[name]["numtypes"]
        nk.reset_launches()
        out = nk.nn_ut_b(*block, p)
        torch.cuda.synchronize()
        assert launched(nk) == {"nn_ut_b": 1}
        ref = nk.nn_ut_b_plain(*block, p)
        assert out[0].shape == (block[2].shape[0], 2 * p.nchem * p.u_len)
        assert out[1].shape == (block[2].shape[0], p.nb_base)
        assert rel_err(out, ref) <= RTOL
        assert all(torch.equal(a, b)
                   for a, b in zip(out, nk.nn_ut_b(*block, p)))
        n_t = nn_tables(p).n_t
        N = block[2].shape[0]
        vg = torch.zeros((N, n_t, n_t), dtype=torch.float64, device=cuda)
        z = torch.zeros((N, p.nz), dtype=torch.float64, device=cuda)
        gF = torch.zeros(tuple(jidx.shape[:2]) + (3,), dtype=torch.float64,
                         device=cuda)
        for call in (lambda: nk.nn_dedu_vg(z[:, :p.ntriples], z, z, p),
                     lambda: nk.nn_dedu_vg_t(vg, z, z, p),
                     lambda: nk.nn_pair_force(vg, *block, p),
                     lambda: nk.nn_pair_force_t(gF, jidx, *block, p)):
            with pytest.raises(ValueError, match="one element"):
                call()
        return
    p, block, jidx, rev = grid_block(CASES[name], cuda)
    N, K = block[2].shape
    n_t = nn_tables(p).n_t
    nconf, A = jidx.shape[:2]
    rng = np.random.default_rng(13)

    def t(*shape):
        return torch.as_tensor(rng.normal(size=shape), device=cuda)

    ut = nk.nn_ut_b_plain(*block, p)[0]
    z = sk.zlist_plain(ut, p)
    dEdB, vgc, vg, gF = (t(N, p.ntriples), t(N, n_t, n_t), t(N, n_t, n_t),
                         t(nconf, A, 3))
    g = t(nconf, A, K, 3)
    calls = {
        "nn_ut_b": (lambda: nk.nn_ut_b(*block, p),
                    lambda: nk.nn_ut_b_plain(*block, p)),
        "nn_dedu_vg": (lambda: [nk.nn_dedu_vg(dEdB, *z, p)],
                       lambda: [nk.nn_dedu_vg_plain(dEdB, *z, p)]),
        "nn_dedu_vg_t": (lambda: [nk.nn_dedu_vg_t(vgc, *z, p)],
                         lambda: [nk.nn_dedu_vg_t_plain(vgc, *z, p)]),
        "nn_pair_force": (lambda: [nk.nn_pair_force(vg, *block, p)],
                          lambda: [nk.nn_pair_force_plain(vg, *block, p)]),
        "nn_pair_force_t": (
            lambda: [nk.nn_pair_force_t(gF, jidx, *block, p)],
            lambda: [nk.nn_pair_force_t_plain(gF, jidx, *block, p)]),
        "nn_pair_gather": (lambda: [nk.nn_pair_gather(g, rev)],
                           lambda: [nk.nn_pair_gather_plain(g, rev)]),
    }
    nk.reset_launches()
    outs = {k: kernel() for k, (kernel, _) in calls.items()}
    torch.cuda.synchronize()
    assert launched(nk) == {k: 1 for k in calls}
    for k, (kernel, plain) in calls.items():
        assert rel_err(outs[k], plain()) <= RTOL, k
        assert all(torch.equal(a, b) for a, b in zip(outs[k], kernel())), k


def test_nn_cached_force_gradient_matches_plain_autograd(cuda):
    """The gradient of a force loss with respect to MLP parameters through
    NnCachedForce (K2, K10, K11, the gather; backward K11T, K10T) and
    through autograd of the plain versions."""
    from fitsnap_tpu_torch.kernels import nn_kernels as nk
    from fitsnap_tpu_torch.models.mlp import atom_energies

    p, block, jidx, rev = grid_block(CASES["tj6"], cuda)
    nconf, A, K = jidx.shape
    N, W = nconf * A, p.ntriples
    ut = nk.nn_ut_b_plain(*block, p)[0]
    rng = np.random.default_rng(14)
    x0 = torch.as_tensor(rng.normal(size=(N, W)), device=cuda)
    target = torch.as_tensor(rng.normal(size=(nconf, A, 3)), device=cuda)
    params = [(torch.as_tensor(rng.normal(size=(1, a, b)) / np.sqrt(a),
                               device=cuda).requires_grad_(True),
               torch.as_tensor(rng.normal(size=(1, b)), device=cuda)
               .requires_grad_(True))
              for a, b in ((W, 5), (5, 1))]
    leaves = [t for wb in params for t in wb]

    def grads(force):
        x = x0.clone().requires_grad_(True)
        e = atom_energies(params, x, torch.zeros(N, dtype=torch.int32,
                                                 device=cuda)).sum()
        dedx, = torch.autograd.grad(e, x, create_graph=True)
        loss = ((force(dedx) - target) ** 2).sum() + e ** 2
        return torch.autograd.grad(loss, leaves)

    def plain(d):
        vg = nk.nn_dedu_vg_plain(d, *sk.zlist_plain(ut, p), p)
        g = nk.nn_pair_force_plain(vg, *block, p)
        return nk.nn_pair_gather_plain(g.reshape(nconf, A, K, 3), rev)

    sk.reset_launches()
    nk.reset_launches()
    out = grads(lambda d: nk.NnCachedForce.apply(d, ut, block[0], jidx,
                                                 *block[1:], rev, p))
    torch.cuda.synchronize()
    assert launched(sk) == {"zlist": 1}
    assert launched(nk) == {"nn_dedu_vg": 1, "nn_pair_force": 1,
                            "nn_pair_gather": 1, "nn_pair_force_t": 1,
                            "nn_dedu_vg_t": 1}
    assert rel_err(out, grads(plain)) <= 1e-10


# The force gather at its edges: (nconf, A, K) and how the lists are drawn.
# k41: rows of 3 x 41 doubles (not 16-byte aligned) and an atom no one
# neighbors (its rev row all -1); r1: each atom the neighbor of one slot
# (R = 1); r60: every slot's neighbor is atom 0 (R = 60 > 32 and > K = 20;
# atoms 1 and 2 have rows all -1); wide: 640 atoms (more than 4 x 132).
GATHER_CASES = {"k41": (2, 6, 41), "r1": (2, 7, 1), "r60": (1, 3, 20),
                "wide": (5, 128, 16)}


def gather_block(name, device):
    """Pair gradients g (nconf, A, K, 3) and the reverse table rev (nconf,
    A, R) of seeded lists with masked slots (r1, r60: none), rows of rev
    increasing and padded with -1."""
    nconf, A, K = GATHER_CASES[name]
    rng = np.random.default_rng(21)
    jidx = rng.integers(0, A, (nconf, A, K))
    mask = rng.uniform(size=(nconf, A, K)) < 0.8
    if name == "k41":
        jidx[0][jidx[0] == 5] = 4
    elif name == "r1":
        jidx[:] = (np.arange(A)[None, :, None] + 1) % A
        mask[:] = True
    elif name == "r60":
        jidx[:] = 0
        mask[:] = True
    slots = [[np.flatnonzero((jidx[c] == m).ravel() & mask[c].ravel())
              for m in range(A)] for c in range(nconf)]
    R = max(len(x) for row in slots for x in row)
    rev = np.full((nconf, A, R), -1)
    for c, row in enumerate(slots):
        for m, x in enumerate(row):
            rev[c, m, :len(x)] = x
    return (torch.as_tensor(rng.normal(size=(nconf, A, K, 3)), device=device),
            torch.as_tensor(rev, dtype=torch.int32, device=device))


@pytest.mark.parametrize("name", list(GATHER_CASES))
def test_gather_edges_match_plain(cuda, name):
    """The force gather against its plain version, launched once, and bit
    for bit from run to run."""
    from fitsnap_tpu_torch.kernels import nn_kernels as nk

    g, rev = gather_block(name, cuda)
    R = {"k41": None, "r1": 1, "r60": 60, "wide": None}[name]
    assert R is None or rev.shape[2] == R
    nk.reset_launches()
    out = nk.nn_pair_gather(g, rev)
    torch.cuda.synchronize()
    assert launched(nk) == {"nn_pair_gather": 1}
    assert rel_err([out], [nk.nn_pair_gather_plain(g, rev)]) <= RTOL
    assert torch.equal(out, nk.nn_pair_gather(g, rev))


# K11T at its edges: (CASES-like spec, nconf, A, K).  twojmax 6, 8, 10 and
# 12 (n_t 28, 45, 66, 91; from twojmax 10 the kernel takes more than 256
# threads, its second launch shape); twojmax 13 and 14 (n_t 105, 120:
# K11's shared memory holds fewer records than masked pairs, so its
# prologues run in several smaller chunks); twojmax 15 and 16 (n_t 136 and
# 153, the largest grids: K11T's tiles split over two blocks an atom); 200 slots (more than 128
# masked pairs: two rounds of prologues); 640 atoms (wide) and 2 (narrow).
K11T_CASES = {
    "tj6": (CASES["tj6"], 2, 6, 40),
    "tj8": (dict(CASES["tj6"], twojmax=["8"]), 2, 6, 40),
    "tj10": (dict(CASES["tj6"], twojmax=["10"]), 2, 6, 40),
    "tj12": (dict(CASES["tj6"], twojmax=["12"]), 1, 4, 24),
    "tj13_k128": (dict(CASES["tj6"], twojmax=["13"]), 1, 3, 128),
    "tj14_k200": (dict(CASES["tj6"], twojmax=["14"]), 1, 3, 200),
    "tj15": (dict(CASES["tj6"], twojmax=["15"]), 1, 3, 40),
    "tj16_k200": (dict(CASES["tj6"], twojmax=["16"]), 1, 3, 200),
    "tj6_k200": (CASES["tj6"], 2, 3, 200),
    "tj6_wide": (CASES["tj6"], 4, 160, 16),
    "tj6_narrow": (CASES["tj6"], 1, 2, 40),
}


# K9's largest grid: twojmax 16 (n_t 153, 187 KB of shared memory); its
# element channels: the InP model's two at twojmax 6 (wselfallflag and
# bnormflag), 200 slots (two rounds of prologues), three channels, and two
# at twojmax 8
INP_TJ6 = dict(CASES["tj4_two_elements"], twojmax=["6", "6"], chemflag=1,
               wselfallflag=1, bnormflag=1, switchinnerflag=0)
K9_CASES = dict(K11T_CASES, tj16=(dict(CASES["tj6"], twojmax=["16"]), 1, 3,
                                  40),
                tj6_chem2=(INP_TJ6, 2, 6, 40),
                tj6_chem2_k200=(dict(INP_TJ6, wselfallflag=0), 1, 3, 200),
                tj4_chem3=(dict(CHEM_CASES["tj2_chem3"],
                                twojmax=["4"] * 3), 2, 6, 40),
                tj8_chem2=(dict(INP_TJ6, twojmax=["8", "8"]), 1, 4, 40))


def k11t_case(name, device):
    """K9_CASES[name]'s block (grid_block's lists) with a masked hole before
    live pairs (slot 3 of atom 0) and a masked-in pair past the SNAP cutoff
    (slot 5, zero weight)."""
    spec, nconf, A, K = K9_CASES[name]
    p, block, jidx, _ = grid_block(spec, device, nconf, A, K)
    disp, _, mask, _ = block
    mask[0, 3] = False
    mask[0, 4] = True
    disp[0, 5] = torch.tensor([0.0, 5.5, 0.0], dtype=disp.dtype)
    mask[0, 5] = True
    return p, block, jidx


@pytest.mark.parametrize("name", list(K11T_CASES))
def test_k11t_edges_match_plain(cuda, name):
    """K11T against its plain version on grid_block's lists (a padded
    atom, random masked holes) with a masked hole before live pairs and a
    masked-in pair past the SNAP cutoff (zero weight), launched once, the
    padded atom's grid exactly 0, and bit for bit from run to run."""
    from fitsnap_tpu_torch.kernels import nn_kernels as nk

    p, block, jidx = k11t_case(name, cuda)
    gF = torch.as_tensor(np.random.default_rng(15).normal(
        size=tuple(jidx.shape[:2]) + (3,)), device=cuda)
    nk.reset_launches()
    out = nk.nn_pair_force_t(gF, jidx, *block, p)
    torch.cuda.synchronize()
    assert launched(nk) == {"nn_pair_force_t": 1}
    assert rel_err([out], [nk.nn_pair_force_t_plain(gF, jidx, *block, p)]) \
        <= RTOL
    assert not out[-1].any()
    assert torch.equal(out, nk.nn_pair_force_t(gF, jidx, *block, p))


@pytest.mark.parametrize("name", list(K11T_CASES))
def test_k11_edges_match_plain(cuda, name):
    """K11 against its plain version on `k11t_case`'s lists and a seeded
    grid cotangent, launched once; every slot that is not live (masked out,
    past the cutoff, of the padded atom) exactly 0; bit for bit from run to
    run."""
    from fitsnap_tpu_torch.kernels import nn_kernels as nk
    from fitsnap_tpu_torch.ops.snap import nn_tables

    p, block, _ = k11t_case(name, cuda)
    mask = block[2]
    n_t = nn_tables(p).n_t
    vg = torch.as_tensor(np.random.default_rng(16).normal(
        size=(mask.shape[0], n_t, n_t)), device=cuda)
    nk.reset_launches()
    out = nk.nn_pair_force(vg, *block, p)
    torch.cuda.synchronize()
    assert launched(nk) == {"nn_pair_force": 1}
    assert rel_err([out], [nk.nn_pair_force_plain(vg, *block, p)]) <= RTOL
    assert not out[~mask].any() and not out[0, 5].any()
    assert not out[-1].any()
    assert torch.equal(out, nk.nn_pair_force(vg, *block, p))


@pytest.mark.parametrize("name", list(K11T_CASES))
def test_k10t_edges_match_plain(cuda, name):
    """K10T against its plain version on the z-lists of `k11t_case`'s atoms
    and a seeded grid cotangent, launched once, and bit for bit from run to
    run; then on all atoms but the last (an odd count where the case's is
    even)."""
    from fitsnap_tpu_torch.kernels import nn_kernels as nk
    from fitsnap_tpu_torch.ops.snap import nn_tables

    p, block, _ = k11t_case(name, cuda)
    N = block[2].shape[0]
    n_t = nn_tables(p).n_t
    z = sk.zlist_plain(nk.nn_ut_b_plain(*block, p)[0], p)
    vgc = torch.as_tensor(np.random.default_rng(17).normal(
        size=(N, n_t, n_t)), device=cuda)
    nk.reset_launches()
    out = nk.nn_dedu_vg_t(vgc, *z, p)
    torch.cuda.synchronize()
    assert launched(nk) == {"nn_dedu_vg_t": 1}
    assert rel_err([out], [nk.nn_dedu_vg_t_plain(vgc, *z, p)]) <= RTOL
    assert torch.equal(out, nk.nn_dedu_vg_t(vgc, *z, p))
    part = [x[:N - 1].contiguous() for x in (vgc, *z)]
    assert rel_err([nk.nn_dedu_vg_t(*part, p)],
                   [nk.nn_dedu_vg_t_plain(*part, p)]) <= RTOL


@pytest.mark.parametrize("name", list(K9_CASES))
def test_k9_edges_match_plain(cuda, name):
    """K9 against its plain version on `k11t_case`'s lists (and at twojmax
    16, n_t 153, whose grid leaves the least shared memory beside it; and
    in its element-channel mode, atom 0's neighbors then all of one
    element, so that its other channels hold no pair), launched once: the
    atom with every slot masked out gets the self term as its ut and the
    self term's B, as the twin's; bit for bit from run to run."""
    from fitsnap_tpu_torch.kernels import nn_kernels as nk

    p, block, _ = k11t_case(name, cuda)
    if p.nchem > 1:
        block[1][0] = 1
    nk.reset_launches()
    out = nk.nn_ut_b(*block, p)
    torch.cuda.synchronize()
    assert launched(nk) == {"nn_ut_b": 1}
    ref = nk.nn_ut_b_plain(*block, p)
    assert rel_err(out, ref) <= RTOL
    alone = self_ut(p, int(block[3][-1]))
    assert torch.equal(out[0][-1], alone)
    assert torch.equal(ref[0][-1], alone)
    assert (out[1][-1] - ref[1][-1]).abs().max() <= RTOL * ref[1].abs().max()
    assert all(torch.equal(a, b) for a, b in zip(out, nk.nn_ut_b(*block, p)))


def test_k9_refuses_channel_grids_past_shared_memory(cuda):
    """Two element channels at twojmax 14 (n_t 120: two grids of 225 KB)
    pass a block's shared memory: K9 refuses them (invalid argument), as it
    refuses one channel from twojmax 17, and writes nothing."""
    from fitsnap_tpu_torch.kernels import nn_kernels as nk

    spec = dict(INP_TJ6, twojmax=["14", "14"])
    p, block, _, _ = grid_block(spec, cuda, 1, 2, 8)
    nk.reset_launches()
    with pytest.raises(RuntimeError, match="nn_ut_b: CUDA error"):
        nk.nn_ut_b(*block, p)
    assert launched(nk) == {}


@pytest.mark.parametrize("name", list(K11T_CASES))
def test_k10_edges_match_plain(cuda, name):
    """K10 against its plain version on the z-lists of `k11t_case`'s atoms
    (the last, every slot masked out, of the self term alone) and a seeded
    dE/dB, launched once, and bit for bit from run to run; then on all
    atoms but the last."""
    from fitsnap_tpu_torch.kernels import nn_kernels as nk

    p, block, _ = k11t_case(name, cuda)
    N = block[2].shape[0]
    z = sk.zlist_plain(nk.nn_ut_b_plain(*block, p)[0], p)
    dEdB = torch.as_tensor(np.random.default_rng(18).normal(
        size=(N, p.ntriples)), device=cuda)
    nk.reset_launches()
    out = nk.nn_dedu_vg(dEdB, *z, p)
    torch.cuda.synchronize()
    assert launched(nk) == {"nn_dedu_vg": 1}
    ref = nk.nn_dedu_vg_plain(dEdB, *z, p)
    assert rel_err([out], [ref]) <= RTOL
    assert (out[-1] - ref[-1]).abs().max() <= RTOL * ref.abs().max()
    assert torch.equal(out, nk.nn_dedu_vg(dEdB, *z, p))
    part = [x[:N - 1].contiguous() for x in (dEdB, *z)]
    assert rel_err([nk.nn_dedu_vg(*part, p)],
                   [nk.nn_dedu_vg_plain(*part, p)]) <= RTOL


def streamed_batch(device):
    """Positions batch of three configs (2 atoms in a 3.3 A cell, 4 atoms
    in a 5 A cell, a padded config) with 5 atom slots, on `device`."""
    rng = np.random.default_rng(6)
    cut, A = 4.8, 5
    cells = [(2, np.eye(3) * 3.3), (4, np.eye(3) * 5.0)]
    nvec = np.max([required_shifts(c, cut) for _, c in cells], 0)
    shifts = shift_table(nvec).astype(np.float64)
    S = len(shifts)
    pos = np.zeros((3, A, 3))
    svec = np.zeros((3, S, 3))
    natoms = np.zeros(3, np.int32)
    kmax = 0
    for c, (na, cell) in enumerate(cells):
        pos[c, :na] = rng.uniform(0, 1, (na, 3)) @ cell.T
        svec[c] = shifts @ cell.T
        natoms[c] = na
        kmax = max(kmax, count_neighbors(pos[c, :na], cell, na, cut))
    def dev(x, dtype=torch.float64):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return (dev(pos), dev(np.zeros_like(pos)), dev(svec),
            dev(np.zeros_like(svec)), dev(natoms, torch.int32), cut,
            -(-kmax // 8) * 8)


def test_k8_k8r_match_plain(cuda):
    args = streamed_batch(cuda)
    sk.reset_launches()
    disp, jidx, mask = sk.device_neighbors(*args)
    ref = sk.device_neighbors_plain(*args)
    rev, dropped = sk.reverse_table(jidx, mask)
    rref, dref = sk.reverse_table_plain(*ref[1:])
    torch.cuda.synchronize()
    assert sk.launches()["device_neighbors"] == 1
    assert sk.launches()["reverse_table"] == 1
    assert torch.equal(mask, ref[2]) and torch.equal(jidx, ref[1])
    assert (disp - ref[0]).abs().max().item() <= 1e-12
    assert torch.equal(rev, rref) and torch.equal(dropped, dref)
    assert int(dropped.sum()) == 0 and not mask[2].any()
    assert not mask[1, 4].any()           # the padded atom
    own = (jidx[0] == torch.arange(5, device=cuda)[:, None]) & mask[0]
    assert own[:2].any()                  # an atom meets its own image


# K8 at its edges: (cells, cutoff, atom slots A, K rule).  Each cell is
# (atoms, lattice); K is the largest neighbor count rounded up to 8, less 5
# where truncated, or fixed.  triclinic: 6 atoms in a skewed cell;
# two_atom_s343: bcc at 3.3 A with a 6.7 A cutoff (S = 343); bcc_ties: a
# perfect 16-atom supercell (every shell a tie); truncation: the same
# jittered, K = count - 5; empty: a config of no atom beside a real one;
# padded: 8 atom slots for 6 and 2 atoms (padded atoms and neighbor rows);
# self_image: one atom in a 3 A cube (its own images are its neighbors);
# a768_s27 and a160_s125: the sizes the kernel refused before (12 S A
# bytes over one block's shared memory), the second also the wide shape (K
# above half the shared buffer: each atom's pairs in global scratch);
# prune: 128 atoms at a 13.5 A cutoff, about 570 valid pairs an atom
# against K = 64 (the shared buffer pruned); wide_prune: a160_s125 with
# K = 300 (the global buffer pruned).  The 1,024-atom configs past the
# cap run in chip_smoke.py; here A stays under K8_FUSED_ATOMS.
K8_CASES = {
    "triclinic": ("triclinic", 4.8, 6, "count"),
    "two_atom_s343": ("bcc1", 6.7, 2, "count"),
    "bcc_ties": ("bcc2", 4.8, 16, "count"),
    "truncation": ("bcc2_jitter", 4.8, 16, "count - 5"),
    "empty": ("empty", 4.8, 6, "count"),
    "padded": ("padded", 4.8, 8, "count"),
    "self_image": ("one", 4.8, 1, "count"),
    "a768_s27": ("bcc_8x8x6", 4.8, 768, "count"),
    "a160_s125": ("bcc_4x4x5", 17.0, 160, "count"),
    "prune": ("bcc4_jitter", 13.5, 128, 64),
    "wide_prune": ("bcc_4x4x5", 17.0, 160, 300),
}
# the same in the split shape (a bin pass into global scratch, then the
# select pass), which the wrapper takes above K8_FUSED_ATOMS atom slots
K8_CASES.update({f"{k}_split": K8_CASES[k] for k in
                 ("triclinic", "empty", "padded", "a768_s27", "prune",
                  "wide_prune")})


def k8_case(name, device):
    """K8_CASES[name]'s arguments of device_neighbors on `device`: seeded
    positions with lo parts of 1e-17, the shift table of the largest
    required shifts."""
    from fitsnap_tpu_torch.tools import synthetic

    kind, cut, A, krule = K8_CASES[name]
    rng = np.random.default_rng(60)

    def bcc(reps, jitter=0.0):
        pos, rows = synthetic.supercell(synthetic.BCC, 3.3, reps)
        return pos + jitter * rng.normal(size=pos.shape), rows.T

    skew = np.array([[5.1, 0.4, 0.3], [0.0, 4.7, 0.8], [0.0, 0.0, 5.5]]).T
    cells = {
        "triclinic": lambda: [(rng.uniform(0, 1, (6, 3)) @ skew.T, skew)],
        "bcc1": lambda: [bcc((1, 1, 1))],
        "bcc2": lambda: [bcc((2, 2, 2))],
        "bcc2_jitter": lambda: [bcc((2, 2, 2), 0.1)],
        "empty": lambda: [(rng.uniform(0, 1, (6, 3)) @ skew.T, skew),
                          (np.zeros((0, 3)), np.eye(3) * 5.0)],
        "padded": lambda: [(rng.uniform(0, 1, (6, 3)) @ skew.T, skew),
                           bcc((1, 1, 1), 0.05)],
        "one": lambda: [(np.array([[0.3, 0.2, 0.1]]), np.eye(3) * 3.0)],
        "bcc_8x8x6": lambda: [bcc((8, 8, 6), 0.05)],
        "bcc_4x4x5": lambda: [bcc((4, 4, 5), 0.05)],
        "bcc4_jitter": lambda: [bcc((4, 4, 4), 0.05)],
    }[kind]()
    nvec = np.max([required_shifts(c, cut) for _, c in cells], 0)
    shifts = shift_table(nvec).astype(np.float64)
    C, S = len(cells), len(shifts)
    pos = np.zeros((C, A, 3))
    pos_lo = np.zeros((C, A, 3))
    svec = np.zeros((C, S, 3))
    natoms = np.zeros(C, np.int32)
    count = 0
    for c, (p, cell) in enumerate(cells):
        na = len(p)
        pos[c, :na] = p
        pos_lo[c, :na] = rng.normal(size=(na, 3)) * 1e-17
        svec[c] = shifts @ cell.T
        natoms[c] = na
        if na:
            count = max(count, count_neighbors(p, cell, na, cut))
    K = -(-count // 8) * 8 if krule == "count" else \
        count - 5 if krule == "count - 5" else krule
    K = min(K, S * A)

    def dev(x, dtype=torch.float64):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return (dev(pos), dev(pos_lo), dev(svec), dev(np.zeros_like(svec)),
            dev(natoms, torch.int32), cut, K)


@pytest.mark.parametrize("name", list(K8_CASES))
def test_k8_edges_match_plain(cuda, name, monkeypatch):
    """K8 against its plain version: mask and jidx equal, disp within
    1e-12, one wrapper call, bit for bit from run to run."""
    if name.endswith("_split"):
        monkeypatch.setattr(sk, "K8_FUSED_ATOMS", 0)
        name = name.removesuffix("_split")
    args = k8_case(name, cuda)
    C, A = args[0].shape[:2]
    S, K = args[2].shape[1], args[6]
    if name in ("a768_s27", "a160_s125"):
        assert 12 * S * A > 232448          # refused before
    if name in ("a160_s125", "wide_prune"):
        assert K > sk.K8_BUF // 2           # the wide shape
    sk.reset_launches()
    disp, jidx, mask = sk.device_neighbors(*args)
    torch.cuda.synchronize()
    assert sk.launches()["device_neighbors"] == 1
    ref = sk.device_neighbors_plain(*args)
    assert torch.equal(mask, ref[2]) and torch.equal(jidx, ref[1])
    assert (disp - ref[0]).abs().max().item() <= 1e-12
    again = sk.device_neighbors(*args)
    assert all(torch.equal(x, y) for x, y in zip((disp, jidx, mask), again))
    listed = mask.sum(-1)
    if name == "truncation":
        assert int(listed.max()) == K        # some atom lost neighbors
    if name in ("prune", "wide_prune"):
        assert bool((listed == K).all())
    if name == "empty":
        assert not mask[1].any()
    if name == "padded":
        assert not mask[1, 2:].any() and not mask[0, 6:].any()
    if name == "self_image":
        assert bool(mask[0, 0].any()) and bool((jidx[0, 0][mask[0, 0]] == 0)
                                               .all())


def k8r_lists(name):
    """Seeded lists (jidx, mask) of K8r's cases, each slot column a
    permutation of the atoms unless said otherwise: "repeats",
    destinations repeated within rows (each row's first slots copied to
    later ones); "truncated", half the slots pointing at one of three
    atoms, whose rows overflow the width K; "a37", 37 atoms of 13 slots
    (neither a multiple of 32, nor a slot count that the kernel's 16-slot
    loads divide); "a600", two configs of 600 atoms x 128 slots (a config
    larger than one block's shared memory); "a5000", one config of 5,000
    atoms x 8 slots (many blocks of destination rows)."""
    rng = np.random.default_rng({"repeats": 50, "truncated": 51, "a37": 52,
                                 "a600": 53, "a5000": 54}[name])
    C, A, K = {"repeats": (3, 64, 40), "truncated": (2, 40, 16),
               "a37": (5, 37, 13), "a600": (2, 600, 128),
               "a5000": (1, 5000, 8)}[name]
    # a permutation of the atoms per (config, slot column): no atom is the
    # destination of more than K slots
    jidx = np.argsort(rng.random((C, K, A)), -1).transpose(0, 2, 1)
    if name == "repeats":
        jidx[:, :, K // 2:] = jidx[:, :, :K - K // 2]
    if name == "truncated":
        jidx = np.where(rng.random((C, A, K)) < 0.5,
                        rng.integers(0, 3, (C, A, K)), jidx)
    mask = rng.random((C, A, K)) < 0.8
    mask[:, -1] = False                   # a padded atom
    return (torch.as_tensor(np.ascontiguousarray(jidx, np.int32)).cuda(),
            torch.as_tensor(mask).cuda())


@pytest.mark.parametrize("name", ["repeats", "truncated", "a37", "a600",
                                  "a5000"])
def test_k8r_matches_plain(cuda, name):
    """K8r's table and dropped counts equal its plain version's, bit for
    bit from run to run."""
    jidx, mask = k8r_lists(name)
    sk.reset_launches()
    rev, dropped = sk.reverse_table(jidx, mask)
    again = sk.reverse_table(jidx, mask)
    ref = sk.reverse_table_plain(jidx, mask)
    torch.cuda.synchronize()
    assert sk.launches()["reverse_table"] == 2
    assert torch.equal(rev, ref[0]) and torch.equal(dropped, ref[1])
    assert torch.equal(again[0], rev) and torch.equal(again[1], dropped)
    assert (int(dropped.sum()) > 0) == (name == "truncated")


def test_k5_k7_match_plain(cuda):
    """The ZBL reference (energy, forces, virial) and the normal equations
    (direct and residual) on rows made from random per-pair gradients of
    the K8 batch."""
    pos, _, _, _, natoms, cut, K = args = streamed_batch(cuda)
    disp, jidx, mask = sk.device_neighbors_plain(*args)
    rev = sk.reverse_table_plain(jidx, mask)[0]
    C, A = natoms.shape[0], pos.shape[1]
    types = torch.as_tensor([[0, 1, 0, 0, 0]] * C, dtype=torch.int32,
                            device=cuda)
    zbl = build_zbl(4.0, 4.8, {(0, 0): (73, 73), (0, 1): (73, 41)}, 2)
    table = zbl_table(zbl, cuda)
    k5_args = (disp, jidx, mask, rev, types, table, 4.0, 4.8)
    sk.reset_launches()
    out = sk.zbl_eav(*k5_args)
    again = sk.zbl_eav(*k5_args)
    ref = sk.zbl_eav_plain(*k5_args)
    torch.cuda.synchronize()
    assert sk.launches()["zbl_eav"] == 2
    assert sk.launches()["pair_scatter_rows"] == 0
    assert rel_err(out, ref) <= RTOL and ref[0][:2].abs().min() > 0
    assert all(torch.equal(a, b) for a, b in zip(out, again))

    rng = np.random.default_rng(2)
    T, Wr = 2, 6

    def dev(*shape):
        return torch.as_tensor(rng.normal(size=shape), device=cuda)

    rows = {"e_cols": dev(C, T * Wr), "force_rows": dev(C, A, 3, T * Wr),
            "virial_rows": dev(C, 6, T * Wr), "ref_e": dev(C),
            "ref_f": dev(C, A, 3), "ref_v": dev(C, 6)}
    truths = (dev(C), dev(C, A, 3), dev(C, 6))
    weights = (dev(C).abs(), dev(C).abs(), dev(C).abs())
    coeff = dev(T * Wr + T)
    for const_cols, flags, x, layout in (
            (True, {"energy": 1, "force": 1, "stress": 1}, None, "snap"),
            (True, {"energy": 1, "force": 1, "stress": 1}, coeff, "snap"),
            (False, {"energy": 1, "force": 0, "stress": 1}, None, "snap"),
            (True, {"energy": 1, "force": 1, "stress": 1}, None, "ace"),
            (True, {"energy": 1, "force": 1, "stress": 0}, coeff, "ace")):
        c = x if const_cols else None
        sk.reset_launches()
        out = sk.normal_contrib(rows, truths, weights, natoms, types, T,
                                const_cols, flags, c, c is None, layout)
        ref = sk.normal_contrib_plain(rows, truths, weights, natoms, types,
                                      T, const_cols, flags, c, c is None,
                                      layout)
        torch.cuda.synchronize()
        assert sk.launches()["normal_contrib"] == 1
        assert rel_err(out[1:2], ref[1:2]) <= RTOL
        if c is None:
            assert rel_err(out[:1], ref[:1]) <= RTOL
        assert out[2].item() == ref[2].item()


ACE_CASES = {
    "one_element": dict(numtypes=1, ranks=[1, 2, 3, 4], nmax=[8, 2, 2, 1],
                        lmax=[1, 2, 2, 1], lmin=[1, 1, 1, 1], nmaxbase=8,
                        rcutfac=[4.6], lmbda=[3.06], rcinner=[0.0],
                        drcinner=[0.01]),
    "two_elements": dict(numtypes=2, ranks=[1, 2, 3, 4], nmax=[6, 3, 2, 1],
                         lmax=[1, 2, 2, 1], lmin=[0, 0, 1, 1], nmaxbase=6,
                         rcutfac=[4.5, 4.2, 4.2, 4.0],
                         lmbda=[3.0, 2.8, 2.8, 2.5],
                         rcinner=[0.0, 1.4, 1.4, 0.0],
                         drcinner=[0.01, 0.4, 0.4, 0.01]),
}


@pytest.mark.parametrize("name", sorted(ACE_CASES))
def test_k13_k14_match_plain(cuda, name):
    spec = ACE_CASES[name]
    plan = build_ace_plan(SimpleNamespace(b_basis="minsub", **spec))
    N, K, nel = 12, 40, spec["numtypes"]
    rng = np.random.default_rng(7)
    d = rng.normal(size=(N, K, 3))
    d *= rng.uniform(0.9, 5.0, (N, K, 1)) / np.linalg.norm(d, axis=-1,
                                                          keepdims=True)
    mask = rng.uniform(size=(N, K)) < 0.85
    mask[-1] = False
    args = (torch.as_tensor(d, device=cuda),
            torch.as_tensor(rng.integers(0, nel, (N, K)), dtype=torch.int32,
                            device=cuda),
            torch.as_tensor(mask, device=cuda),
            torch.as_tensor(rng.integers(0, nel, N), dtype=torch.int32,
                            device=cuda))
    ak.reset_launches()
    A, Jp = ak.ace_pair_basis(*args, plan)
    ref = ak.ace_pair_basis_plain(*args, plan)
    out14 = ak.ace_b_dbdd(ref[0], ref[1], args[3], plan)
    ref14 = ak.ace_b_dbdd_plain(ref[0], ref[1], args[3], plan)
    torch.cuda.synchronize()
    assert ak.launches() == {"ace_pair_basis": 1, "ace_b_dbdd": 1}
    assert rel_err((A, Jp), ref) <= RTOL
    assert rel_err(out14, ref14) <= RTOL
    assert (A[:, 0] == 1).all() and (Jp[..., 0] == 0).all()
    dead = ~args[2]
    assert (Jp[:, dead] == 0).all() and torch.isfinite(Jp).all()


K13_PLANS = {
    "lmax8": dict(numtypes=1, ranks=[1, 2, 3, 4], nmax=[8, 2, 2, 1],
                  lmax=[0, 8, 3, 2], lmin=[0, 0, 0, 0], nmaxbase=8,
                  rcutfac=[4.6], lmbda=[3.0], rcinner=[0.0],
                  drcinner=[0.01]),
    "two_elements": ACE_CASES["two_elements"],
}
K13_CONVENTIONS = [("pace_px", "4pi"), ("pace_mx", "std"),
                   ("v0_t1", "racah"), ("pace_x", "4pi")]


@pytest.mark.parametrize("conv", K13_CONVENTIONS)
@pytest.mark.parametrize("name", sorted(K13_PLANS))
def test_k13_lmax_and_conventions_match_plain(cuda, name, conv):
    """K13 past its old limits: lmax 8, every convention pair, on 12 atoms
    x 37 slots (a partial last tile) with masked pairs, pairs past the
    cutoff and an empty atom; 1e-11, structurally zero columns and dead
    slots exactly 0, bit for bit from run to run."""
    spec = K13_PLANS[name]
    plan = build_ace_plan(SimpleNamespace(b_basis="minsub", **spec))
    plan.radial, plan.ylm = conv
    N, K, nel = 12, 37, spec["numtypes"]
    rng = np.random.default_rng(13)
    d = rng.normal(size=(N, K, 3))
    d *= rng.uniform(0.9, 5.0, (N, K, 1)) / np.linalg.norm(d, axis=-1,
                                                          keepdims=True)
    mask = rng.uniform(size=(N, K)) < 0.85
    mask[-1] = False
    args = (torch.as_tensor(d, device=cuda),
            torch.as_tensor(rng.integers(0, nel, (N, K)), dtype=torch.int32,
                            device=cuda),
            torch.as_tensor(mask, device=cuda),
            torch.as_tensor(rng.integers(0, nel, N), dtype=torch.int32,
                            device=cuda))
    ak.reset_launches()
    A, Jp = ak.ace_pair_basis(*args, plan)
    again = ak.ace_pair_basis(*args, plan)
    ref = ak.ace_pair_basis_plain(*args, plan)
    torch.cuda.synchronize()
    assert ak.launches()["ace_pair_basis"] == 2
    assert rel_err((A, Jp), ref) <= RTOL
    assert torch.equal(A, again[0]) and torch.equal(Jp, again[1])
    nA = plan.nA
    zero = [0, nA] + [nA + s for s, (_, _, l, m) in enumerate(
        slot_table(plan)) if s and (l < 0 or m == 0)]
    assert (Jp[..., zero] == 0).all() and (A[:, 0] == 1).all()
    assert (Jp[:, ~args[2]] == 0).all() and torch.isfinite(Jp).all()


def zbl_case(name, rng):
    """A batch of the ZBL cases of tests/test_torch_zbl.py (host lists at
    5.4 A, two types): (disp, jidx, mask, types) as numpy, with `types`
    (T, pairs with coefficients)."""
    from fitsnap_tpu_torch.tools import synthetic

    if name == "self_image":
        cells = [(rng.uniform(0, 3.1, (2, 3)), np.diag([3.1, 3.2, 3.0])),
                 (rng.uniform(0, 2.9, (2, 3)), np.diag([2.9, 3.3, 3.1]))]
    else:
        sizes = {"padding": [5, 9], "many_configs": [9] * 40}.get(
            name, [12, 12, 12])
        cells = []
        for na in sizes:
            pos, rows = synthetic.liquid(rng, na, 0.06, 1.5)
            cells.append((pos, rows.T))
    A = max(len(p) for p, _ in cells) + (name == "padding")
    K = max(count_neighbors(p, c, len(p), 5.4) for p, c in cells)
    lists = [host_neighbors(p, c, len(p), 5.4, a_pad=A, k_pad=K)[:3]
             for p, c in cells]
    disp, jidx, mask = (np.stack(x) for x in zip(*lists))
    types = np.stack([np.pad(np.arange(len(p)) % 2, (0, A - len(p)))
                      for p, _ in cells]).astype(np.int32)
    if name == "one_sided":
        ci, ii, kk = np.nonzero(mask)
        pick = rng.choice(len(ci), size=len(ci) // 6, replace=False)
        mask[ci[pick], ii[pick], kk[pick]] = False
    return disp, jidx, mask, types


@pytest.mark.parametrize("name", ["two_types", "one_sided", "self_image",
                                  "no_coeff", "padding", "many_configs"])
def test_zbl_eav_matches_plain(cuda, name):
    """K5 (the whole reference in one launch) against its plain version on
    the cases of tests/test_torch_zbl.py and on 40 configs of 9 atoms
    (three blocks a config, the tickets of 40 configs), 1e-11, one launch a
    call, bit for bit from run to run."""
    rng = np.random.default_rng(21)
    disp, jidx, mask, types = (torch.as_tensor(x, device=cuda)
                               for x in zbl_case(name, rng))
    pairs = {(0, 0): (73, 73), (0, 1): (73, 41)}
    if name != "no_coeff":
        pairs[(1, 1)] = (41, 41)
    table = zbl_table(build_zbl(4.0, 4.8, pairs, 2), cuda)
    rev = sk.reverse_table_plain(jidx, mask)[0]
    k5_args = (disp, jidx, mask, rev, types, table, 4.0, 4.8)
    sk.reset_launches()
    out = sk.zbl_eav(*k5_args)
    again = sk.zbl_eav(*k5_args)
    ref = sk.zbl_eav_plain(*k5_args)
    torch.cuda.synchronize()
    assert sk.launches()["zbl_eav"] == 2
    assert rel_err(out, ref) <= RTOL and ref[0].abs().min() > 0
    assert all(torch.equal(a, b) for a, b in zip(out, again))


REF_SPIN = ("pair_coeff * * spin/exchange/biquadratic biquadratic 4.5 0.2827 "
            "-4.747 0.7810 0.0234 -1.0 0.6 offset {}")
REF_MODES = {
    "coul": ["pair_style coul/cut 5.0"],
    "spin": ["pair_style spin/exchange/biquadratic 4.5",
             REF_SPIN.format("yes")],
    "spin_no_offset": ["pair_style spin/exchange/biquadratic 4.5",
                       REF_SPIN.format("no")],
    "zbl_coul_spin": [
        "pair_style hybrid/overlay zero 10.0 zbl 4.0 4.8 coul/cut 5.0 "
        "spin/exchange/biquadratic 4.5", "pair_coeff * * zero",
        "pair_coeff 1 1 zbl 73 73", "pair_coeff 1 2 zbl 73 41",
        "pair_coeff * * coul/cut", REF_SPIN.format("yes")],
}


@pytest.mark.parametrize("mode", sorted(REF_MODES))
@pytest.mark.parametrize("name", ["two_types", "one_sided", "self_image",
                                  "padding"])
def test_ref_eav_modes_match_plain(cuda, name, mode):
    """K5's ref_eav entry point (coul/cut, the spin term with and without
    its offset, and zbl + coul/cut + spin with a type pair without ZBL
    coefficients) against its plain version on the ZBL cases with seeded
    charges and unit spins (zero on padding atoms): 1e-11, one launch a
    call, bit for bit from run to run; the spin term adds no force or
    virial."""
    from fitsnap_tpu_torch.ops import refpot

    rng = np.random.default_rng(23)
    disp, jidx, mask, types = (torch.as_tensor(x, device=cuda)
                               for x in zbl_case(name, rng))
    C, A = types.shape
    real = mask.any(2)
    q = torch.as_tensor(rng.normal(0.0, 0.4, (C, A)), device=cuda) * real
    spins = torch.as_tensor(rng.normal(size=(C, A, 3)), device=cuda)
    spins = spins / spins.norm(dim=-1, keepdim=True) * real[..., None]
    spec = refpot.parse_reference(
        SimpleNamespace(lmp_pairdecl=REF_MODES[mode]), 2)
    rev = sk.reverse_table_plain(jidx, mask)[0]
    args = (disp, jidx, mask, rev, types, spec)
    kw = {"spins": spins, "charges": q}
    sk.reset_launches()
    out = refpot.reference_eav(*args, **kw)
    again = refpot.reference_eav(*args, **kw)
    ref = refpot.reference_eav(*args, plain=True, **kw)
    torch.cuda.synchronize()
    assert sk.launches()["zbl_eav"] == 2
    assert rel_err(out, ref) <= RTOL and ref[0].abs().max() > 0
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    if mode.startswith("spin"):
        assert (out[1] == 0).all() and (out[2] == 0).all()


@pytest.mark.parametrize("name", sorted(K13_PLANS))
def test_k13_spline_matches_plain(cuda, name):
    """K13 with spline radials (delta 0.001, the tables read from device
    memory) on 12 atoms x 37 slots with masked pairs, pairs past the cutoff
    and an empty atom, against its plain version: 1e-11, dead slots
    exactly 0, bit for bit from run to run."""
    spec = K13_PLANS[name]
    plan = build_ace_plan(SimpleNamespace(b_basis="minsub", **spec))
    plan.spline_delta = 0.001
    N, K, nel = 12, 37, spec["numtypes"]
    rng = np.random.default_rng(17)
    d = rng.normal(size=(N, K, 3))
    d *= rng.uniform(0.5, 5.0, (N, K, 1)) / np.linalg.norm(d, axis=-1,
                                                          keepdims=True)
    mask = rng.uniform(size=(N, K)) < 0.85
    mask[-1] = False
    args = (torch.as_tensor(d, device=cuda),
            torch.as_tensor(rng.integers(0, nel, (N, K)), dtype=torch.int32,
                            device=cuda),
            torch.as_tensor(mask, device=cuda),
            torch.as_tensor(rng.integers(0, nel, N), dtype=torch.int32,
                            device=cuda))
    ak.reset_launches()
    A, Jp = ak.ace_pair_basis(*args, plan)
    again = ak.ace_pair_basis(*args, plan)
    ref = ak.ace_pair_basis_plain(*args, plan)
    torch.cuda.synchronize()
    assert ak.launches()["ace_pair_basis"] == 2
    assert rel_err((A, Jp), ref) <= RTOL
    assert torch.equal(A, again[0]) and torch.equal(Jp, again[1])
    assert (Jp[:, ~args[2]] == 0).all() and torch.isfinite(Jp).all()


# ---------------------------------------------------------------------------
# K15, K15V, K15T: the custom pairwise NN's descriptor kernels
# ---------------------------------------------------------------------------

CUTOFF, NRAD, N3B = 5.0, 8, 23


def custom_block(name, device, num_3body=N3B):
    """Inputs of K15, K15V and K15T: disp (N, A, K, 3), mask, jidx, rev
    and random cotangents of NRAD + num_3body columns.  "cells": two
    periodic cells of 6 atoms (one padded atom) with lists to 5.5 A, so
    pairs at r >= the 5.0 cutoff and on the 3.5-5.0 ramp occur, and a few
    live slots masked out of the middle of a row; "k512": 4 atoms of 512
    slots, about 380 live at random directions and radii 1.5-5.5 A; "k1":
    one slot per atom; "b864": 4 x 8 atoms of 64 slots, about 58 live (the
    pairwise set's (8, 64) bucket at batch 4); "k512w": 160 atoms of 512
    slots, about 380 live, and "b464": 4 x 64 atoms of 64 slots, about 58
    live (more atoms than an H100 has SMs)."""
    rng = np.random.default_rng({"cells": 31, "k512": 32, "k1": 33,
                                 "b864": 35, "k512w": 36, "b464": 37}[name])
    if name == "cells":
        cfgs = []
        for na, edge in ((6, 5.2), (5, 6.0)):
            pos = rng.uniform(0, edge, (na, 3))
            disp, jidx, mask, kmax = host_neighbors(
                pos, np.eye(3) * edge, na, 5.5)
            cfgs.append((disp, jidx, mask, kmax, na))
        N, A = 2, 6
        K = max(c[3] for c in cfgs)
        disp = np.zeros((N, A, K, 3))
        jidx = np.zeros((N, A, K), np.int32)
        mask = np.zeros((N, A, K), bool)
        for c, (d, ji, m, km, na) in enumerate(cfgs):
            disp[c, :na, :km], jidx[c, :na, :km] = d, ji
            mask[c, :na, :km] = m
        mask[0, 1, 2] = mask[1, 3, 0] = False
    else:
        N, A, K = {"k512": (1, 4, 512), "k1": (1, 4, 1),
                   "b864": (4, 8, 64), "k512w": (1, 160, 512),
                   "b464": (4, 64, 64)}[name]
        u = rng.normal(size=(N, A, K, 3))
        disp = u / np.linalg.norm(u, axis=-1, keepdims=True) \
            * rng.uniform(1.5, 5.5, (N, A, K, 1))
        mask = rng.random((N, A, K)) < (0.9 if K == 64 else 0.75)
        mask[0, -1] = False
        jidx = rng.integers(0, A, (N, A, K)).astype(np.int32)
    rev = np.full((N, A, 1), -1, np.int32)
    if name == "cells":
        rows = []
        for c in range(N):
            rows.append(reverse_neighbors(jidx[c], mask[c], A))
        R = max(r.shape[1] for r in rows)
        rev = np.full((N, A, R), -1, np.int32)
        for c, r in enumerate(rows):
            rev[c, :, :r.shape[1]] = r
    D = NRAD + num_3body
    return [torch.as_tensor(x, device=device) for x in (
        disp, mask, jidx, rev, rng.normal(size=(N, A, K, D)),
        rng.normal(size=(N, A, K)), rng.normal(size=(N, A, K, 3)),
        rng.normal(size=(N, A, 3)))]


# case: (block, Gaussian columns)
K15_CASES = {"cells": ("cells", N3B), "k512": ("k512", N3B),
             "k1": ("k1", N3B), "cells-m1": ("cells", 1),
             "cells-m2": ("cells", 2), "cells-m6": ("cells", 6),
             "b864": ("b864", N3B)}


@pytest.mark.parametrize("name", list(K15_CASES))
def test_k15_k15v_k15t_match_plain(cuda, name):
    """K15's descriptors and envelope, K15V's pair gradient and K15T's
    tangent (given h, and from force cotangents through jidx) against
    their plain versions; dead slots exactly zero; runs repeat bit for
    bit."""
    from fitsnap_tpu_torch.kernels import custom_kernels as ck

    block, num_3body = K15_CASES[name]
    disp, mask, jidx, _, gd, ee, h, gF = custom_block(block, cuda, num_3body)
    args = (CUTOFF, NRAD, num_3body)
    ck.reset_launches()
    desc, fc = ck.pair_desc(disp, mask, *args)
    g = ck.pair_desc_vjp(gd, ee, disp, mask, *args)
    jh = ck.pair_desc_jvp(h, disp, mask, *args)
    jg = ck.pair_desc_jvp(gF, disp, mask, *args, jidx=jidx)
    torch.cuda.synchronize()
    assert launched(ck) == {"pair_desc": 1, "pair_desc_vjp": 1,
                            "pair_desc_jvp": 2}
    assert rel_err([desc, fc], ck.pair_desc_plain(disp, mask, *args)) <= RTOL
    assert rel_err([g], [ck.pair_desc_vjp_plain(gd, ee, disp, mask, *args)]) \
        <= RTOL
    assert rel_err(jh, ck.pair_desc_jvp_plain(h, disp, mask, *args)) <= RTOL
    assert rel_err(jg, ck.pair_desc_jvp_plain(gF, disp, mask, *args,
                                              jidx=jidx)) <= RTOL
    dead = ~mask
    for out in (desc, fc, g, *jh, *jg):
        assert (out[dead] == 0).all()
    again = ck.pair_desc(disp, mask, *args)
    assert torch.equal(desc, again[0]) and torch.equal(fc, again[1])
    assert torch.equal(g, ck.pair_desc_vjp(gd, ee, disp, mask, *args))
    assert torch.equal(jg[0], ck.pair_desc_jvp(gF, disp, mask, *args,
                                               jidx=jidx)[0])
    assert torch.equal(jh[0], ck.pair_desc_jvp(h, disp, mask, *args)[0])


def plain_by_atoms(fn, tensors, step):
    """fn over slices of `step` atoms (axis 1) of the (N, A, ...) tensors,
    joined along that axis: the plain versions hold (K, K, M) tensors of
    every atom they take."""
    A = tensors[0].shape[1]
    parts = [fn(*(t[:, a:a + step] for t in tensors))
             for a in range(0, A, step)]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, 1)
    return tuple(torch.cat(p, 1) for p in zip(*parts))


# case: (block, Gaussian columns), each block with more atoms than SMs
K15_WIDE_CASES = {f"{b}-m{m}": (b, m) for b in ("k512w", "b464")
                  for m in (N3B, 1, 2)}


@pytest.mark.parametrize("name", list(K15_WIDE_CASES))
def test_k15v_k15t_wide_shape_match_plain(cuda, name):
    """K15's descriptors and envelope, K15V's pair gradient and K15T's
    tangent (given h, and from force cotangents through jidx) in their
    wide launch shape, taken when the launch has more atoms than the card
    has SMs, against their plain versions: at K = 512 (more items and sum
    slots than threads) and at 64 slots, with 23, 1 and 2 Gaussian
    columns; dead slots exactly zero; runs repeat bit for bit."""
    from fitsnap_tpu_torch.kernels import custom_kernels as ck

    block, num_3body = K15_WIDE_CASES[name]
    disp, mask, jidx, _, gd, ee, h, gF = custom_block(block, cuda, num_3body)
    N, A, K = mask.shape
    assert N * A > torch.cuda.get_device_properties(0).multi_processor_count
    args = (CUTOFF, NRAD, num_3body)
    ck.reset_launches()
    desc, fc = ck.pair_desc(disp, mask, *args)
    g = ck.pair_desc_vjp(gd, ee, disp, mask, *args)
    jh = ck.pair_desc_jvp(h, disp, mask, *args)
    jg = ck.pair_desc_jvp(gF, disp, mask, *args, jidx=jidx)
    torch.cuda.synchronize()
    assert launched(ck) == {"pair_desc": 1, "pair_desc_vjp": 1,
                            "pair_desc_jvp": 2}

    def plain(fn, *tensors):
        return plain_by_atoms(lambda *t: fn(*t, *args), tensors,
                              max(1, 4096 // K))

    assert rel_err([desc, fc], plain(ck.pair_desc_plain, disp, mask)) \
        <= RTOL
    assert rel_err([g], [plain(ck.pair_desc_vjp_plain, gd, ee, disp, mask)]) \
        <= RTOL
    assert rel_err(jh, plain(ck.pair_desc_jvp_plain, h, disp, mask)) <= RTOL
    assert rel_err(jg, plain(ck.pair_desc_jvp_plain, ck._gather_t(gF, jidx),
                             disp, mask)) <= RTOL
    dead = ~mask
    for out in (desc, fc, g, *jh, *jg):
        assert (out[dead] == 0).all()
    again = ck.pair_desc(disp, mask, *args)
    assert torch.equal(desc, again[0]) and torch.equal(fc, again[1])
    assert torch.equal(g, ck.pair_desc_vjp(gd, ee, disp, mask, *args))
    assert torch.equal(jg[0], ck.pair_desc_jvp(gF, disp, mask, *args,
                                               jidx=jidx)[0])
    assert torch.equal(jh[0], ck.pair_desc_jvp(h, disp, mask, *args)[0])


def test_pair_desc_force_gradient_matches_plain_autograd(cuda):
    """The gradient of a force-and-energy loss with respect to MLP
    parameters through PairDescForce (K15V and the gather; backward K15T)
    against plain double autograd through the plain descriptors."""
    from fitsnap_tpu_torch.kernels import custom_kernels as ck
    from fitsnap_tpu_torch.kernels import nn_kernels as nk
    from fitsnap_tpu_torch.models.mlp import atom_energies
    from fitsnap_tpu_torch.ops import custom_desc as ops

    disp, mask, jidx, rev, *_, target = custom_block("cells", cuda)
    N, A, K, _ = disp.shape
    D = NRAD + N3B
    rng = np.random.default_rng(34)
    mean = torch.as_tensor(rng.normal(size=D) * 0.1, device=cuda)
    std = torch.as_tensor(rng.uniform(0.5, 1.5, D), device=cuda)
    params = [(torch.as_tensor(rng.normal(size=(1, a, b)) / np.sqrt(a),
                               device=cuda).requires_grad_(True),
               torch.as_tensor(rng.normal(size=(1, b)), device=cuda)
               .requires_grad_(True))
              for a, b in ((D, 6), (6, 1))]
    leaves = [t for wb in params for t in wb]
    elem = torch.zeros(N * A * K, dtype=torch.int32, device=cuda)

    def loss(e, forces):
        return ((forces - target) ** 2).sum() + e ** 2

    def kernel_grads():
        desc, fc = ck.pair_desc(disp, mask, CUTOFF, NRAD, N3B)
        x = ((desc - mean) / std).reshape(-1, D).requires_grad_(True)
        e_pair = atom_energies(params, x, elem).reshape(N, A, K)
        e = (e_pair * fc).sum()
        dedx, = torch.autograd.grad(e, x, create_graph=True)
        forces = ck.PairDescForce.apply(
            (dedx / std).reshape(N, A, K, D), e_pair * mask, disp, mask,
            jidx, rev, CUTOFF, NRAD, N3B)
        return torch.autograd.grad(loss(e, forces), leaves)

    def plain_grads():
        d = disp.clone().requires_grad_(True)
        desc = ops.pair_descriptors(d, mask, CUTOFF, NRAD, N3B)
        x = ((desc - mean) / std).reshape(-1, D)
        e_pair = atom_energies(params, x, elem).reshape(N, A, K)
        e = (e_pair * ops.envelope(d, mask, CUTOFF)).sum()
        g, = torch.autograd.grad(e, d, create_graph=True)
        return torch.autograd.grad(
            loss(e, nk.nn_pair_gather_plain(g, rev)), leaves)

    ck.reset_launches()
    nk.reset_launches()
    out = kernel_grads()
    torch.cuda.synchronize()
    assert launched(ck) == {"pair_desc": 1, "pair_desc_vjp": 1,
                            "pair_desc_jvp": 1}
    assert launched(nk) == {"nn_pair_gather": 1}
    assert rel_err(out, plain_grads()) <= 1e-10


# ---------------------------------------------------------------------------
# float32: the streamed linear SNAP fit's instantiations of K1 (window
# shape), K2, K3 (whole rows), K4, K5 (zbl_eav), K7 and K8 against their
# plain versions at float32 on the card: 1e-5 relative to each output's
# largest magnitude (float32 sums in other orders), K8's mask and jidx and
# K8r's table exactly and K8's disp within 2 ulp (the same rounded steps as
# the plain version); the modes outside the slice refuse float32 with their
# ROADMAP.md queue item, and float16 or mixed inputs are refused.
# ---------------------------------------------------------------------------

F32 = torch.float32
RTOL32 = 1e-5


def ulps32(a, b):
    """The largest distance between two float32 tensors, in ulps of the
    larger magnitude of each pair."""
    a, b = a.double(), b.double()
    ulp = torch.maximum(a.abs(), b.abs()).clamp(min=1e-30) * 2.0 ** -23
    return ((a - b).abs() / ulp).max().item()


def split32(x):
    """hi/lo float32 parts of a float64 array (as `pack_batch_pos`)."""
    hi = np.asarray(x, np.float32)
    return hi, np.asarray(x - hi.astype(np.float64), np.float32)


F32_CASES = dict(CASES, tj10=TJ10, tj12=dict(CASES["tj6"], twojmax=["12"]))


@pytest.mark.parametrize("name", sorted(F32_CASES))
def test_f32_k1_k3_match_plain(cuda, name):
    """K1-K3 at float32 on test_k1_k3_match_plain's block, the plan's
    float32 tables (`SnapParams.cast`), at twojmax 4, 6, 10 and 12 (the
    float32 window shape and whole rows reach 12): outputs float32, 1e-5,
    and the float32 launch counts."""
    spec = F32_CASES[name]
    p = shared_params(spec, cuda).cast(F32)
    N, K = 16, 40
    rng = np.random.default_rng(4)
    d = rng.normal(size=(N, K, 3))
    d *= rng.uniform(1.2, 4.9, (N, K, 1)) / np.linalg.norm(d, axis=-1,
                                                          keepdims=True)
    mask = rng.uniform(size=(N, K)) < 0.85
    mask[-1] = False
    nel = spec["numtypes"]
    args = (torch.as_tensor(d, dtype=F32, device=cuda),
            torch.as_tensor(rng.integers(0, nel, (N, K)), dtype=torch.int32,
                            device=cuda),
            torch.as_tensor(mask, device=cuda),
            torch.as_tensor(rng.integers(0, nel, N), dtype=torch.int32,
                            device=cuda))
    sk.reset_launches()
    k1 = sk.pair_u_duals(*args, p)
    ref1 = sk.pair_u_duals_plain(*args, p)
    J, ut = ref1
    k2 = sk.zlist(ut, p)
    ref2 = sk.zlist_plain(ut, p)
    k3 = sk.dbdd(ut, *ref2, J, p)
    ref3 = sk.dbdd_plain(ut, *ref2, J, p)
    torch.cuda.synchronize()
    counts = sk.launches()
    assert counts["pair_u_duals_f32"] == counts["zlist_f32"] \
        == counts["dbdd_f32"] == 1
    for out, ref in ((k1, ref1), (k2, ref2), (k3, ref3)):
        assert all(x.dtype == F32 for x in out)
        assert rel_err(out, ref) <= RTOL32
    assert not k1[0][:, -1].any()          # the atom with every slot masked


@pytest.mark.parametrize("shape", ["fused", "split"])
def test_f32_k8_k8r_match_plain(cuda, monkeypatch, shape):
    """K8 at float32 (hi/lo parts of the K8 batch) in both launch shapes:
    mask and jidx equal, disp within 2 ulp; K8r's table exactly."""
    if shape == "split":
        monkeypatch.setattr(sk, "K8_FUSED_ATOMS", 0)
    pos, _, svec, _, natoms, cut, K = streamed_batch(cuda)
    ph, pl = (torch.as_tensor(x, device=cuda)
              for x in split32(pos.cpu().numpy()))
    sh, sl = (torch.as_tensor(x, device=cuda)
              for x in split32(svec.cpu().numpy()))
    args = (ph, pl, sh, sl, natoms, cut, K)
    sk.reset_launches()
    disp, jidx, mask = sk.device_neighbors(*args)
    ref = sk.device_neighbors_plain(*args)
    rev, dropped = sk.reverse_table(jidx, mask)
    rref, dref = sk.reverse_table_plain(*ref[1:])
    torch.cuda.synchronize()
    assert sk.launches()["device_neighbors_f32"] == 1
    assert disp.dtype == F32
    assert torch.equal(mask, ref[2]) and torch.equal(jidx, ref[1])
    assert ulps32(disp, ref[0]) <= 2
    assert torch.equal(rev, rref) and torch.equal(dropped, dref)


def test_f32_k8_at_50_angstrom(cuda):
    """K8 at float32 on 30 atoms at 40-50 A coordinates (the JAX test's
    case): mask and jidx equal to its plain version, disp within 2 ulp of
    it and within 1e-6 A of the float64 host lists."""
    rng = np.random.default_rng(7)
    cell = np.triu(rng.uniform(4, 11, (3, 3)))
    cell[0, 1] *= 0.3
    cell[0, 2] *= 0.3
    cell[1, 2] *= 0.3
    pos = rng.uniform(0, 1, (30, 3)) @ cell.T + 40.0
    cut, na = 5.0, 30
    dh, _, mh, kh = host_neighbors(pos, cell, na, cut)
    sv = shift_table(required_shifts(cell, cut)).astype(np.float64) @ cell.T
    args = tuple(torch.as_tensor(x, device=cuda)[None]
                 for x in split32(pos) + split32(sv))
    args += (torch.tensor([na], dtype=torch.int32, device=cuda), cut, kh)
    disp, jidx, mask = sk.device_neighbors(*args)
    ref = sk.device_neighbors_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(mask, ref[2]) and torch.equal(jidx, ref[1])
    assert ulps32(disp, ref[0]) <= 2
    dp, mp = disp[0].double().cpu().numpy(), mask[0].cpu().numpy()
    for a in range(na):
        hs = np.array(sorted(map(tuple, dh[a][mh[a]])))
        ds = np.array(sorted(map(tuple, dp[a][mp[a]])))
        assert hs.shape == ds.shape and np.abs(hs - ds).max() <= 1e-6


@pytest.mark.parametrize("name", ["two_atom_s343", "bcc_ties", "truncation",
                                  "empty", "padded", "self_image",
                                  "a160_s125", "prune", "wide_prune",
                                  "a768_s27_split", "prune_split",
                                  "wide_prune_split"])
def test_f32_k8_edges_match_plain(cuda, name, monkeypatch):
    """K8 at float32 on the K8_CASES edges (ties, truncation, S = 343, an
    empty config, padded atoms, a self image, the pruned buffer in shared
    memory and in global scratch, the split shape), the hi/lo float32
    parts of their positions: mask and jidx equal, disp within 2 ulp, bit
    for bit from run to run."""
    if name.endswith("_split"):
        monkeypatch.setattr(sk, "K8_FUSED_ATOMS", 0)
        name = name.removesuffix("_split")
    pos, _, svec, _, natoms, cut, K = k8_case(name, cuda)
    args = tuple(torch.as_tensor(x, device=cuda) for x in
                 split32(pos.cpu().numpy()) + split32(svec.cpu().numpy()))
    args += (natoms, cut, K)
    sk.reset_launches()
    disp, jidx, mask = sk.device_neighbors(*args)
    ref = sk.device_neighbors_plain(*args)
    again = sk.device_neighbors(*args)
    torch.cuda.synchronize()
    assert sk.launches()["device_neighbors_f32"] == 2
    assert torch.equal(mask, ref[2]) and torch.equal(jidx, ref[1])
    assert ulps32(disp, ref[0]) <= 2
    assert all(torch.equal(x, y) for x, y in zip((disp, jidx, mask), again))


@pytest.mark.parametrize("name", ["x1_t1", "x30_t1", "x31_t2"])
def test_f32_k4_matches_plain(cuda, name):
    """K4 at float32 at the SNAP widths (and 1, the reference's), on two
    periodic cells (self images repeated in the reverse table)."""
    X, T = {"x1_t1": (1, 1), "x30_t1": (30, 1), "x31_t2": (31, 2)}[name]
    rng = np.random.default_rng(3)
    cfgs = []
    for na, edge in ((2, 3.3), (5, 5.0)):
        pos = rng.uniform(0, edge, (na, 3))
        disp, jidx, mask, kmax = host_neighbors(pos, np.eye(3) * edge, na,
                                                4.8)
        cfgs.append((disp, mask, kmax, reverse_neighbors(jidx, mask, na),
                     na))
    C, A = 2, 6
    K = max(c[2] for c in cfgs)
    R = max(c[3].shape[1] for c in cfgs)
    disp = np.zeros((C, A, K, 3))
    msk = np.zeros((C, A, K), bool)
    rev = np.full((C, A, R), -1, np.int32)
    types = np.zeros((C, A), np.int32)
    for c, (dsp, m, km, rv, na) in enumerate(cfgs):
        disp[c, :na, :km] = dsp
        msk[c, :na, :km] = m
        rev[c, :na, :rv.shape[1]] = np.where(rv < 0, -1,
                                             rv // km * K + rv % km)
        types[c, :na] = rng.integers(0, T, na)
    g = rng.normal(size=(C, A, X, K, 3)) * msk[:, :, None, :, None]
    args = [torch.as_tensor(x, device=cuda)
            for x in (g.astype(np.float32), disp.astype(np.float32), msk,
                      rev, types)]
    sk.reset_launches()
    out = sk.pair_scatter_rows(*args, T)
    ref = sk.pair_scatter_rows_plain(*args, T)
    torch.cuda.synchronize()
    assert sk.launches()["pair_scatter_rows_f32"] == 1
    assert all(x.dtype == F32 for x in out)
    assert rel_err(out, ref) <= RTOL32


def test_f32_k5_k7_match_plain(cuda):
    """K5 (zbl_eav) and K7 at float32 on test_k5_k7_match_plain's batch:
    K5's outputs float32 within 1e-5; K7's direct mode float64 (AtA, Atb)
    and its residual mode float32 (A^T r), each within 1e-5 of the plain
    version's float32 rows widened in the JAX order."""
    pos, _, svec, _, natoms, cut, K = streamed_batch(cuda)
    ph, pl = (torch.as_tensor(x, device=cuda)
              for x in split32(pos.cpu().numpy()))
    sh, sl = (torch.as_tensor(x, device=cuda)
              for x in split32(svec.cpu().numpy()))
    disp, jidx, mask = sk.device_neighbors_plain(ph, pl, sh, sl, natoms, cut,
                                                 K)
    rev = sk.reverse_table_plain(jidx, mask)[0]
    C, A = natoms.shape[0], pos.shape[1]
    types = torch.as_tensor([[0, 1, 0, 0, 0]] * C, dtype=torch.int32,
                            device=cuda)
    zbl = build_zbl(4.0, 4.8, {(0, 0): (73, 73), (0, 1): (73, 41)}, 2)
    table = zbl_table(zbl, cuda, F32)
    k5_args = (disp, jidx, mask, rev, types, table, 4.0, 4.8)
    sk.reset_launches()
    out = sk.zbl_eav(*k5_args)
    ref = sk.zbl_eav_plain(*k5_args)
    torch.cuda.synchronize()
    assert sk.launches()["zbl_eav_f32"] == 1
    assert all(x.dtype == F32 for x in out)
    assert rel_err(out, ref) <= RTOL32 and ref[0][:2].abs().min() > 0

    rng = np.random.default_rng(2)
    T, Wr = 2, 6

    def dev(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=F32,
                               device=cuda)

    rows = {"e_cols": dev(C, T * Wr), "force_rows": dev(C, A, 3, T * Wr),
            "virial_rows": dev(C, 6, T * Wr), "ref_e": dev(C),
            "ref_f": dev(C, A, 3), "ref_v": dev(C, 6)}
    truths = (dev(C), dev(C, A, 3), dev(C, 6))
    weights = (dev(C).abs(), dev(C).abs(), dev(C).abs())
    coeff = dev(T * Wr + T).double()
    flags = {"energy": 1, "force": 1, "stress": 1}
    for c in (None, coeff):
        sk.reset_launches()
        out = sk.normal_contrib(rows, truths, weights, natoms, types, T,
                                True, flags, c, c is None)
        ref = sk.normal_contrib_plain(rows, truths, weights, natoms, types,
                                      T, True, flags, c, c is None)
        torch.cuda.synchronize()
        assert sk.launches()["normal_contrib_f32"] == 1
        assert out[1].dtype == (torch.float64 if c is None else F32)
        assert rel_err(out[1:2], ref[1:2]) <= RTOL32
        if c is None:
            assert out[0].dtype == torch.float64
            assert rel_err(out[:1], ref[:1]) <= RTOL32
        assert out[2].item() == ref[2].item()


def test_f32_off_path_modes_are_refused(cuda):
    """float32 where the card has a float64 kernel only (the chemflag
    modes, K6q, ref_eav, K4's halo mode) names its ROADMAP.md queue item;
    float16 and mixed float inputs are refused; nothing falls back to a
    plain version or to float64."""
    chem = make_params(section(dict(FLAG_CASES["chem_tj4_wself0"])), cuda)
    N, K = 4, 8
    d = torch.full((N, K, 3), 1.5, dtype=F32, device=cuda)
    ints = torch.zeros((N, K), dtype=torch.int32, device=cuda)
    m = torch.ones((N, K), dtype=torch.bool, device=cuda)
    ie = torch.zeros((N,), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="ROADMAP.md"):
        sk.pair_u_duals_chem(d, ints, m, ie, chem.cast(F32))
    quad = make_params(section(dict(FLAG_CASES["quadratic_tj8"])), cuda)
    W = quad.nb_base
    with pytest.raises(TypeError, match="ROADMAP.md"):
        sk.quad_chain(torch.zeros((N, W), dtype=F32, device=cuda),
                      torch.zeros((N, W, K, 3), dtype=F32, device=cuda),
                      quad.cast(F32))
    C, A = 1, N
    jidx = torch.zeros((C, A, K), dtype=torch.int32, device=cuda)
    mask = torch.ones((C, A, K), dtype=torch.bool, device=cuda)
    disp = torch.full((C, A, K, 3), 1.5, dtype=F32, device=cuda)
    types = torch.zeros((C, A), dtype=torch.int32, device=cuda)
    table = torch.zeros((1, 1, 6), dtype=F32, device=cuda)
    with pytest.raises(TypeError, match="ROADMAP.md"):
        sk.zbl_eav(disp, jidx, mask, jidx, types, table, 4.0, 4.8,
                   extra=torch.zeros(9, dtype=torch.float64, device=cuda))
    g = torch.zeros((C, A, 1, K, 3), dtype=F32, device=cuda)
    with pytest.raises(TypeError, match="ROADMAP.md"):
        sk.pair_scatter_rows(g, disp, mask, jidx, types, 1, gather_only=True)
    with pytest.raises(TypeError, match="all float64 or all float32"):
        sk.pair_scatter_rows(g.double(), disp, mask, jidx, types, 1)
    with pytest.raises(TypeError, match="all float64 or all float32"):
        sk.pair_scatter_rows(g.half(), disp.half(), mask, jidx, types, 1)


# ---------------------------------------------------------------------------
# float32: the NN solver's cached and OTF modes' instantiations of K9, K10,
# K10T, K11, K11T and the force gather against their plain versions at
# float32 on the card, at twojmax 4 (two elements, bzeroflag, the inner
# switching function), 6, 8 and 12: 1e-4 relative to each output's largest
# magnitude (float32 sums in other orders; the JAX kit's own float32 runs
# stand 8e-6 from its float64 forces), each launched once as "<name>_f32",
# bit for bit from run to run; the loss gradient through NnCachedForce at
# float32 against autograd through the plain versions at float32, 1e-4;
# and the refusals: twojmax 13, element channels, K12 and K12T.
# ---------------------------------------------------------------------------

RTOL_NN32 = 1e-4
F32_NN_CASES = {"tj4_two_elements": CASES["tj4_two_elements"],
                "tj6": CASES["tj6"], "tj8": dict(CASES["tj6"], twojmax=["8"]),
                "tj12": dict(CASES["tj6"], twojmax=["12"])}


def grid_block32(spec, device):
    """`grid_block` at float32: the plan's float32 copy and the block's
    displacements rounded once."""
    p, block, jidx, rev = grid_block(spec, device)
    return p.cast(F32), (block[0].to(F32),) + block[1:], jidx, rev


@pytest.mark.parametrize("name", sorted(F32_NN_CASES))
def test_f32_k9_k10_k11_match_plain(cuda, name):
    """K9, K10, K10T, K11, K11T and the force gather at float32 against
    their plain versions at float32, each launched once in its float32
    instantiation, outputs float32, bit for bit from run to run."""
    from fitsnap_tpu_torch.kernels import nn_kernels as nk
    from fitsnap_tpu_torch.ops.snap import nn_tables

    p, block, jidx, rev = grid_block32(F32_NN_CASES[name], cuda)
    N, K = block[2].shape
    n_t = nn_tables(p).n_t
    nconf, A = jidx.shape[:2]
    rng = np.random.default_rng(13)

    def t(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=F32,
                               device=cuda)

    ut = nk.nn_ut_b_plain(*block, p)[0]
    z = sk.zlist_plain(ut, p)
    assert ut.dtype == z[0].dtype == F32
    dEdB, vgc, vg, gF = (t(N, p.ntriples), t(N, n_t, n_t), t(N, n_t, n_t),
                         t(nconf, A, 3))
    g = t(nconf, A, K, 3)
    calls = {
        "nn_ut_b": (lambda: nk.nn_ut_b(*block, p),
                    lambda: nk.nn_ut_b_plain(*block, p)),
        "nn_dedu_vg": (lambda: [nk.nn_dedu_vg(dEdB, *z, p)],
                       lambda: [nk.nn_dedu_vg_plain(dEdB, *z, p)]),
        "nn_dedu_vg_t": (lambda: [nk.nn_dedu_vg_t(vgc, *z, p)],
                         lambda: [nk.nn_dedu_vg_t_plain(vgc, *z, p)]),
        "nn_pair_force": (lambda: [nk.nn_pair_force(vg, *block, p)],
                          lambda: [nk.nn_pair_force_plain(vg, *block, p)]),
        "nn_pair_force_t": (
            lambda: [nk.nn_pair_force_t(gF, jidx, *block, p)],
            lambda: [nk.nn_pair_force_t_plain(gF, jidx, *block, p)]),
        "nn_pair_gather": (lambda: [nk.nn_pair_gather(g, rev)],
                           lambda: [nk.nn_pair_gather_plain(g, rev)]),
    }
    nk.reset_launches()
    outs = {k: kernel() for k, (kernel, _) in calls.items()}
    torch.cuda.synchronize()
    assert launched(nk) == {k + "_f32": 1 for k in calls}
    for k, (kernel, plain) in calls.items():
        ref = plain()
        assert all(x.dtype == F32 for x in outs[k]) and all(
            x.dtype == F32 for x in ref), k
        assert rel_err(outs[k], ref) <= RTOL_NN32, k
        assert all(torch.equal(a, b) for a, b in zip(outs[k], kernel())), k


@pytest.mark.parametrize("shape", [(2, 6, 40), (3, 7, 41)])
def test_f32_gather_matches_plain(cuda, shape):
    """The force gather at float32 with its own rows as float4 loads (3K a
    multiple of 4) and as single floats (3 x 41, not 16-byte aligned), on
    the lists of `gather_block`'s k41 case drawn at this shape."""
    from fitsnap_tpu_torch.kernels import nn_kernels as nk

    nconf, A, K = shape
    rng = np.random.default_rng(15)
    mask = rng.uniform(size=(nconf, A, K)) < 0.8
    jidx = rng.integers(0, A, (nconf, A, K))
    slots = [[np.flatnonzero((jidx[c] == m).ravel() & mask[c].ravel())
              for m in range(A)] for c in range(nconf)]
    R = max(len(x) for row in slots for x in row)
    rev = np.full((nconf, A, R), -1)
    for c, row in enumerate(slots):
        for m, x in enumerate(row):
            rev[c, m, :len(x)] = x
    g = torch.as_tensor(rng.normal(size=(nconf, A, K, 3)) * mask[..., None],
                        dtype=F32, device=cuda)
    rev = torch.as_tensor(rev, dtype=torch.int32, device=cuda)
    nk.reset_launches()
    out = nk.nn_pair_gather(g, rev)
    torch.cuda.synchronize()
    assert launched(nk) == {"nn_pair_gather_f32": 1}
    assert out.dtype == F32
    assert rel_err([out], [nk.nn_pair_gather_plain(g, rev)]) <= RTOL_NN32
    assert torch.equal(out, nk.nn_pair_gather(g, rev))


def test_f32_nn_cached_force_gradient_matches_plain_autograd(cuda):
    """The gradient of a force loss through NnCachedForce at float32 (K2,
    K10, K11, the gather; backward K11T, K10T, all `_f32`) against
    autograd through the plain versions at float32."""
    from fitsnap_tpu_torch.kernels import nn_kernels as nk
    from fitsnap_tpu_torch.models.mlp import atom_energies

    p64, block, jidx, rev = grid_block(CASES["tj6"], cuda)
    p = p64.cast(F32)
    block = (block[0].to(F32),) + block[1:]
    nconf, A, K = jidx.shape
    N, W = nconf * A, p.ntriples
    ut = nk.nn_ut_b_plain(*block, p)[0]
    rng = np.random.default_rng(14)
    x0 = torch.as_tensor(rng.normal(size=(N, W)), dtype=F32, device=cuda)
    target = torch.as_tensor(rng.normal(size=(nconf, A, 3)), dtype=F32,
                             device=cuda)
    params = [(torch.as_tensor(rng.normal(size=(1, a, b)) / np.sqrt(a),
                               dtype=F32, device=cuda).requires_grad_(True),
               torch.as_tensor(rng.normal(size=(1, b)), dtype=F32,
                               device=cuda).requires_grad_(True))
              for a, b in ((W, 5), (5, 1))]
    leaves = [t for wb in params for t in wb]

    def grads(force):
        x = x0.clone().requires_grad_(True)
        e = atom_energies(params, x, torch.zeros(N, dtype=torch.int32,
                                                 device=cuda)).sum()
        dedx, = torch.autograd.grad(e, x, create_graph=True)
        loss = ((force(dedx) - target) ** 2).sum() + e ** 2
        return torch.autograd.grad(loss, leaves)

    def plain(d):
        vg = nk.nn_dedu_vg_plain(d, *sk.zlist_plain(ut, p), p)
        g = nk.nn_pair_force_plain(vg, *block, p)
        return nk.nn_pair_gather_plain(g.reshape(nconf, A, K, 3), rev)

    sk.reset_launches()
    nk.reset_launches()
    # the float64 plan given: NnCachedForce takes its float32 copy
    out = grads(lambda d: nk.NnCachedForce.apply(d, ut, block[0], jidx,
                                                 *block[1:], rev, p64))
    torch.cuda.synchronize()
    assert launched(sk) == {"zlist_f32": 1}
    assert launched(nk) == {"nn_dedu_vg_f32": 1, "nn_pair_force_f32": 1,
                            "nn_pair_gather_f32": 1,
                            "nn_pair_force_t_f32": 1, "nn_dedu_vg_t_f32": 1}
    assert all(g.dtype == F32 for g in out)
    assert rel_err(out, grads(plain)) <= RTOL_NN32


def test_f32_nn_refusals(cuda):
    """float32 past the NN slice names its ROADMAP.md queue item and runs
    nothing: the pair-grid kernels at twojmax 13 ("Twojmax 13-16 at
    float32"), K9 with element channels (chemflag), K12 and K12T (the
    precompute mode); a float32 plan with float64 inputs, and mixed types,
    are refused too."""
    from fitsnap_tpu_torch.kernels import launch as kl
    from fitsnap_tpu_torch.kernels import nn_kernels as nk
    from fitsnap_tpu_torch.ops.snap import nn_tables

    p13, block, jidx, _ = grid_block32(dict(CASES["tj6"], twojmax=["13"]),
                                       cuda)
    N, K = block[2].shape
    nk.reset_launches()
    with pytest.raises(TypeError, match=kl.QUEUE_LARGE):
        nk.nn_ut_b(*block, p13)
    vg = torch.zeros((N, 105, 105), dtype=F32, device=cuda)
    with pytest.raises(TypeError, match=kl.QUEUE_LARGE):
        nk.nn_pair_force(vg, *block, p13)
    gF = torch.zeros(tuple(jidx.shape[:2]) + (3,), dtype=F32, device=cuda)
    with pytest.raises(TypeError, match=kl.QUEUE_LARGE):
        nk.nn_pair_force_t(gF, jidx, *block, p13)
    chem, cblock, _, _ = grid_block32(CHEM_CASES["tj4_chem2"], cuda)
    with pytest.raises(TypeError, match=kl.QUEUE_CHEM):
        nk.nn_ut_b(*cblock, chem)
    p, block, _, rev = grid_block32(CASES["tj6"], cuda)
    with pytest.raises(TypeError, match="pass p.cast"):
        nk.nn_ut_b(block[0].double(), *block[1:], p)
    n_t = nn_tables(p).n_t
    with pytest.raises(TypeError, match="all float64 or all float32"):
        nk.nn_pair_force(torch.zeros((N, n_t, n_t), device=cuda,
                                     dtype=torch.float64), *block, p)
    batch = nn_batch(cuda)
    dEdB, G, bjidx, brev = (x.to(F32) if x.is_floating_point() else x
                            for x in batch[:4])
    with pytest.raises(TypeError, match=kl.QUEUE_NN):
        nk.nn_force(dEdB, G, bjidx, brev)
    with pytest.raises(TypeError, match=kl.QUEUE_NN):
        nk.nn_force_t(torch.zeros(tuple(dEdB.shape[:2]) + (3,), dtype=F32,
                                  device=cuda), G, bjidx)
    torch.cuda.synchronize()
    assert launched(nk) == {}
