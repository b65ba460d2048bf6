"""The CUDA kernels K1-K4 against their plain versions on the card.

Needs an NVIDIA GPU and nvcc (the kernels are built at first use); skipped
elsewhere.  The machine with the card has no JAX, which the suite's
conftest imports, so run this file on its own there:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Cases: twojmax 6 with one element, and twojmax 4 with two elements,
bzeroflag and the inner switching function; blocks with masked pairs, a
padded atom and an atom that is its own neighbor through a periodic image.
Tolerance: 1e-11 relative to the largest magnitude of each output (the
kernels sum in another order than the plain versions, at float64).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fitsnap_tpu_torch.kernels import snap_kernels as sk
from fitsnap_tpu_torch.ops.neighbors import host_neighbors, reverse_neighbors
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
    assert sk.launches() == {"pair_u_duals": 1, "zlist": 1, "dbdd": 1,
                             "pair_scatter_rows": 0}
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
