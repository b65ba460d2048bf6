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
padded atom, and a padded config (natoms 0).  Tolerance: 1e-11 relative to
the largest magnitude of each output (the kernels sum in another order
than the plain versions, at float64); K8's mask and jidx and K8r's table
exactly.  K13 and K14 run on 12 atoms x 40 neighbor slots for a
one-element plan (ranks 1-4, lmax up to 2) and a two-element plan with an
inner cutoff on the mixed bonds, with masked pairs, pairs past the cutoff
and an empty atom; K7 also in the ACE layout (two leading constant
columns), and at the widths its output is tiled over (480 and 1,596, both
layouts, direct and residual, with a padded and a one-atom config), bit for
bit from run to run.  K4 with one to three source types at widths 1, 4,
37 (not a multiple of its x-tile) and 600, bit for bit from run to run.
quadraticflag and chemflag: K1-K3 with K3 in three W tiles and K6q at
twojmax 8; the chemflag modes of K1-K3 with two elements at twojmax 4
(wselfallflag 0 and 1, bnormflag) and, with K6q, quadratic x chemflag at
twojmax 2.  K12 and K12T on two small periodic cells with a padded atom
(and twice, to show a run repeats bit for bit), and the gradient of a
force loss with respect to MLP parameters through `NnForce` against
autograd through K12's plain version, 1e-10.  K9, K10, K10T, K11, K11T and
the force gather on two configs of 6 atoms x 40 slots (the two CASES
plans; a self image, masked pairs, a padded atom), each once and bit for
bit from run to run; the force-loss gradient through `NnCachedForce`
against autograd through the plain versions, 1e-10.  K15, K15V and K15T
(the custom pairwise NN's descriptors, their VJP and its transpose, also
through the force gather's transpose) on two periodic cells with pairs
past the cutoff and on the radial ramp and live slots masked mid-row, on
4 atoms of 512 slots, and on one slot per atom: dead slots exactly 0,
bit for bit from run to run; the loss gradient through `PairDescForce`
against double autograd through the plain descriptors, 1e-10.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fitsnap_tpu_torch.kernels import ace_kernels as ak
from fitsnap_tpu_torch.kernels import snap_kernels as sk
from fitsnap_tpu_torch.ops.ace import build_ace_plan
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
    ut = ref1[2]
    k2 = sk.zlist(ut, p)
    ref2 = sk.zlist_plain(ut, p)
    k3 = sk.dbdd(ut, *ref2, ref1[1], p)
    ref3 = sk.dbdd_plain(ut, *ref2, ref1[1], p)
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
    wu, J, ut = ref1
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
        assert sk.dbdd_tiles(p) == (19, 3)
    for out, ref in pairs:
        assert rel_err(out, ref) <= RTOL


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
    p = make_params(section(spec), device)
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


@pytest.mark.parametrize("name", sorted(CASES))
def test_k9_k10_k11_match_plain(cuda, name):
    """K9, K10, K10T, K11, K11T and the force gather against their plain
    versions, each launched once, and bit for bit from run to run."""
    from fitsnap_tpu_torch.kernels import nn_kernels as nk
    from fitsnap_tpu_torch.ops.snap import nn_tables

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


def test_k5_k7_match_plain(cuda):
    """ZBL gradient and the normal equations (direct and residual) on rows
    made from random per-pair gradients of the K8 batch."""
    pos, _, _, _, natoms, cut, K = args = streamed_batch(cuda)
    disp, jidx, mask = sk.device_neighbors_plain(*args)
    C, A = natoms.shape[0], pos.shape[1]
    types = torch.as_tensor([[0, 1, 0, 0, 0]] * C, dtype=torch.int32,
                            device=cuda)
    zbl = build_zbl(4.0, 4.8, {(0, 0): (73, 73), (0, 1): (73, 41)}, 2)
    table = zbl_table(zbl, cuda)
    sk.reset_launches()
    out = sk.zbl_pair_grad(disp, jidx, mask, types, table, 4.0, 4.8)
    ref = sk.zbl_pair_grad_plain(disp, jidx, mask, types, table, 4.0, 4.8)
    torch.cuda.synchronize()
    assert sk.launches()["zbl_pair_grad"] == 1
    assert rel_err(out, ref) <= RTOL and ref[1][:2].abs().min() > 0

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


# ---------------------------------------------------------------------------
# K15, K15V, K15T: the custom pairwise NN's descriptor kernels
# ---------------------------------------------------------------------------

CUTOFF, NRAD, N3B = 5.0, 8, 23


def custom_block(name, device):
    """Inputs of K15, K15V and K15T: disp (N, A, K, 3), mask, jidx, rev
    and random cotangents.  "cells": two periodic cells of 6 atoms (one
    padded atom) with lists to 5.5 A, so pairs at r >= the 5.0 cutoff and
    on the 3.5-5.0 ramp occur, and a few live slots masked out of the
    middle of a row; "k512": 4 atoms of 512 slots, about 380 live at
    random directions and radii 1.5-5.5 A; "k1": one slot per atom."""
    rng = np.random.default_rng({"cells": 31, "k512": 32, "k1": 33}[name])
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
        N, A, K = 1, 4, 512 if name == "k512" else 1
        u = rng.normal(size=(N, A, K, 3))
        disp = u / np.linalg.norm(u, axis=-1, keepdims=True) \
            * rng.uniform(1.5, 5.5, (N, A, K, 1))
        mask = rng.random((N, A, K)) < 0.75
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
    D = NRAD + N3B
    return [torch.as_tensor(x, device=device) for x in (
        disp, mask, jidx, rev, rng.normal(size=(N, A, K, D)),
        rng.normal(size=(N, A, K)), rng.normal(size=(N, A, K, 3)),
        rng.normal(size=(N, A, 3)))]


@pytest.mark.parametrize("name", ["cells", "k512", "k1"])
def test_k15_k15v_k15t_match_plain(cuda, name):
    """K15's descriptors and envelope, K15V's pair gradient and K15T's
    tangent (given h, and from force cotangents through jidx) against
    their plain versions; dead slots exactly zero; runs repeat bit for
    bit."""
    from fitsnap_tpu_torch.kernels import custom_kernels as ck

    disp, mask, jidx, _, gd, ee, h, gF = custom_block(name, cuda)
    args = (CUTOFF, NRAD, N3B)
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
    assert torch.equal(desc, ck.pair_desc(disp, mask, *args)[0])
    assert torch.equal(g, ck.pair_desc_vjp(gd, ee, disp, mask, *args))
    assert torch.equal(jg[0], ck.pair_desc_jvp(gF, disp, mask, *args,
                                               jidx=jidx)[0])


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
