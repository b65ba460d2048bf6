"""The CUDA kernels K1-K5, K7, K8 and K8r against their plain versions on
the card.

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
exactly.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fitsnap_tpu_torch.kernels import snap_kernels as sk
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


def test_k4_matches_plain(cuda):
    """Row scatter over real neighbor lists of two small periodic cells
    (self images repeated in the reverse table), two source types."""
    rng = np.random.default_rng(3)
    cfgs = []
    for na, edge in ((2, 3.3), (5, 5.0)):
        pos = rng.uniform(0, edge, (na, 3))
        disp, jidx, mask, kmax = host_neighbors(pos, np.eye(3) * edge, na,
                                                4.8)
        cfgs.append((disp, jidx, mask, kmax,
                     reverse_neighbors(jidx, mask, na), na))
    C, A, X, T = 2, 6, 4, 2
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
    g = rng.normal(size=(C, A, X, K, 3)) * msk[:, :, None, :, None]
    args = [torch.as_tensor(x, device=cuda)
            for x in (g, disp, msk, rev, types)]
    sk.reset_launches()
    out = sk.pair_scatter_rows(*args, T)
    ref = sk.pair_scatter_rows_plain(*args, T)
    torch.cuda.synchronize()
    assert sk.launches()["pair_scatter_rows"] == 1
    assert rel_err(out, ref) <= RTOL


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
    for const_cols, flags, x in (
            (True, {"energy": 1, "force": 1, "stress": 1}, None),
            (True, {"energy": 1, "force": 1, "stress": 1}, coeff),
            (False, {"energy": 1, "force": 0, "stress": 1}, None)):
        c = x if const_cols else None
        sk.reset_launches()
        out = sk.normal_contrib(rows, truths, weights, natoms, types, T,
                                const_cols, flags, c, c is None)
        ref = sk.normal_contrib_plain(rows, truths, weights, natoms, types,
                                      T, const_cols, flags, c, c is None)
        torch.cuda.synchronize()
        assert sk.launches()["normal_contrib"] == 1
        assert rel_err(out[1:2], ref[1:2]) <= RTOL
        if c is None:
            assert rel_err(out[:1], ref[:1]) <= RTOL
        assert out[2].item() == ref[2].item()
