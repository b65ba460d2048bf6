"""Wrappers of the four CUDA kernels of the linear SNAP path, with their
plain PyTorch versions beside them.

| kernel | source | replaces (fitsnap_tpu) |
| K1 pair_u_duals | csrc/pair_u_duals.cu | ops/snap.py _ck_prologue, _pair_wu_duals, _utot_from_wu |
| K2 zlist | csrc/zlist.cu | ops/snap.py _compute_zcat_pair |
| K3 dbdd | csrc/dbdd.cu | ops/snap.py _dbdu_ylist + the contractions at :956-971 |
| K4 pair_scatter_rows | csrc/pair_scatter.cu | calculators/snap.py:326-343, ops/refpot.py:295-302 |

Each wrapper takes its plain version for tensors on the CPU, launches its
kernel for tensors on a CUDA device, and raises for anything else.  Every
launch adds one to the wrapper's `launches` count.
"""

import ctypes

import torch

from fitsnap_tpu_torch.kernels.build import load
from fitsnap_tpu_torch.ops import snap as ops

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_D = ctypes.c_double

_ARGTYPES = {
    "pair_u_duals": [_P, _P, _P, _P, _P, _D, _D, _D, _I, _I, _LL, _I,
                     _P, _P, _P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P],
    "zlist": [_P, _LL, _I, _P, _P, _P, _P, _I, _P, _P, _P],
    "dbdd": [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _P, _P, _P],
    "pair_scatter_rows": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                          _P, _P],
}
_LIBRARY = {"pair_u_duals": "pair_u_duals", "zlist": "zlist", "dbdd": "dbdd",
            "pair_scatter_rows": "pair_scatter"}


def _fn(name):
    lib = load(_LIBRARY[name])
    fn = getattr(lib, name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return lib, fn


def _on_cpu(*tensors):
    """True when the inputs lie on the CPU; raises unless they lie on one
    CUDA device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs on several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def _check(t, name, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _launch(name, device, *args):
    lib, fn = _fn(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}: "
                           f"{lib.fs_error_string(rc).decode()}")


def _ptr(t):
    return t.data_ptr()


# ---------------------------------------------------------------------------
# K1: pair U expansion with tangents, and its neighbor sum
# ---------------------------------------------------------------------------


def pair_u_duals_plain(disp, jelem, mask, ielem, p):
    """Plain K1: (wu (N, K, 2U), J (3, N, K, 2U), ut (N, 2U))."""
    wu, J = ops._pair_wu_duals(disp, jelem, mask, ielem, p)
    return wu, J, ops._utot_from_wu(wu, p)


def pair_u_duals(disp, jelem, mask, ielem, p):
    """K1 on the card: disp (N, K, 3) f64, jelem (N, K) i32, mask (N, K)
    bool, ielem (N,) i32.  Same outputs as `pair_u_duals_plain`."""
    if _on_cpu(disp, jelem, mask, ielem):
        return pair_u_duals_plain(disp, jelem, mask, ielem, p)
    N, K = mask.shape
    two_u = 2 * p.u_len
    if two_u > 1024:
        raise ValueError(f"pair_u_duals: 2U = {two_u} exceeds one block")
    _check(disp, "disp", torch.float64, (N, K, 3))
    _check(jelem, "jelem", torch.int32, (N, K))
    _check(mask, "mask", torch.bool, (N, K))
    _check(ielem, "ielem", torch.int32, (N,))
    dev = disp.device
    wu = torch.empty((N, K, two_u), dtype=torch.float64, device=dev)
    J = torch.empty((3, N, K, two_u), dtype=torch.float64, device=dev)
    ut = torch.empty((N, two_u), dtype=torch.float64, device=dev)
    _launch("pair_u_duals", dev,
            _ptr(disp), _ptr(jelem), _ptr(mask), _ptr(ielem), _ptr(p.elem),
            p.rcutfac, p.rfac0, p.rmin0, int(p.switchflag),
            int(p.switchinnerflag), N, K, _ptr(p.mono_parent),
            _ptr(p.mono_var), _ptr(p.mono_levels_t),
            len(p.mono_levels) - 1, p.mono_parent.shape[0],
            _ptr(p.l_ptr), _ptr(p.l_row), _ptr(p.l_val), two_u,
            _ptr(p.selfvec), _ptr(wu), _ptr(J), _ptr(ut))
    pair_u_duals.launches += 1
    return wu, J, ut


pair_u_duals.launches = 0


# ---------------------------------------------------------------------------
# K2: z-lists
# ---------------------------------------------------------------------------


def zlist_plain(ut, p):
    """Plain K2: (z_r, z_i), each (N, nz)."""
    return ops._compute_zcat(ut, p)


def zlist(ut, p):
    """K2 on the card: ut (N, 2U) f64 -> (z_r, z_i) (N, nz)."""
    if _on_cpu(ut):
        return zlist_plain(ut, p)
    N = ut.shape[0]
    _check(ut, "ut", torch.float64, (N, 2 * p.u_len))
    zr = torch.empty((N, p.nz), dtype=torch.float64, device=ut.device)
    zi = torch.empty_like(zr)
    _launch("zlist", ut.device, _ptr(ut), N, 2 * p.u_len, _ptr(p.z_ptr),
            _ptr(p.z_i1), _ptr(p.z_i2), _ptr(p.z_c), p.nz, _ptr(zr),
            _ptr(zi))
    zlist.launches += 1
    return zr, zi


zlist.launches = 0


# ---------------------------------------------------------------------------
# K3: dB/dutot, B and the pair jacobian dB/dD
# ---------------------------------------------------------------------------


def dbdd_plain(ut, z_r, z_i, J, p):
    """Plain K3: (B (N, W), dBdD (N, W, K, 3))."""
    zcat = (z_r, z_i)
    dBdu = ops._dbdu_ylist(ut, p, zcat)
    B = ops._bispectrum_from_zcat(ut, zcat, p)
    return B, torch.einsum("awu,caku->awkc", dBdu, J)


def dbdd(ut, z_r, z_i, J, p):
    """K3 on the card: ut (N, 2U), z_r, z_i (N, nz), J (3, N, K, 2U)."""
    if _on_cpu(ut, z_r, z_i, J):
        return dbdd_plain(ut, z_r, z_i, J, p)
    N, K = J.shape[1], J.shape[2]
    U, W = p.u_len, p.ntriples
    _check(ut, "ut", torch.float64, (N, 2 * U))
    _check(z_r, "z_r", torch.float64, (N, p.nz))
    _check(z_i, "z_i", torch.float64, (N, p.nz))
    _check(J, "J", torch.float64, (3, N, K, 2 * U))
    smem = 8 * (W + 24) * 2 * U
    if smem > 232448:
        raise ValueError(f"dbdd: {smem} bytes of shared memory per block")
    dev = ut.device
    bzero = p.bzero if p.bzeroflag else torch.zeros_like(p.bzero)
    B = torch.empty((N, W), dtype=torch.float64, device=dev)
    dBdD = torch.empty((N, W, K, 3), dtype=torch.float64, device=dev)
    _launch("dbdd", dev, _ptr(ut), _ptr(z_r), _ptr(z_i), _ptr(J),
            _ptr(p.y_src), _ptr(p.y_fac), _ptr(bzero), N, K, W, U, p.nz,
            _ptr(B), _ptr(dBdD))
    dbdd.launches += 1
    return B, dBdD


dbdd.launches = 0


# ---------------------------------------------------------------------------
# K4: force and virial rows from a per-pair gradient
# ---------------------------------------------------------------------------

_VIRIAL_PAIRS = ((0, 1, 2, 1, 0, 0), (0, 1, 2, 2, 2, 1))


def pair_scatter_rows_plain(g, disp, vmask, rev, types, ntypes):
    """Plain K4: (force (C, A, 3, T, X), virial (C, 6, T, X)).

    g (C, A, X, K, 3) per-pair gradients; disp (C, A, K, 3); vmask
    (C, A, K) pairs that enter the virial; rev (C, A, R) reverse neighbor
    table (flat slots i*K + k, -1 padded); types (C, A) source types.
    """
    C, A, X, K, _ = g.shape
    R = rev.shape[2]
    oh = torch.nn.functional.one_hot(types.long(), ntypes).to(g.dtype)
    typed = (oh[:, :, None, :, None, None]
             * g.permute(0, 1, 3, 2, 4)[:, :, :, None])   # (C, A, K, T, X, 3)
    width = ntypes * X * 3
    flat = torch.cat([typed.reshape(C, A * K, width),
                      g.new_zeros((C, 1, width))], 1)
    idx = torch.where(rev < 0, A * K, rev).long().reshape(C, A * R, 1)
    scat = torch.gather(flat, 1, idx.expand(C, A * R, width))
    scat = scat.reshape(C, A, R, ntypes, X, 3).sum(2)
    rows = typed.sum(2)
    force = (rows - scat).permute(0, 1, 4, 2, 3)
    dm = disp * vmask[..., None].to(disp.dtype)
    vir = -torch.einsum("cakp,caktxq->cpqtx", dm, typed)
    pa, pb = _VIRIAL_PAIRS
    return force.contiguous(), vir[:, list(pa), list(pb)].contiguous()


def pair_scatter_rows(g, disp, vmask, rev, types, ntypes):
    """K4 on the card; same arguments and outputs as the plain version."""
    if _on_cpu(g, disp, vmask, rev, types):
        return pair_scatter_rows_plain(g, disp, vmask, rev, types, ntypes)
    C, A, X, K, _ = g.shape
    R = rev.shape[2]
    _check(g, "g", torch.float64, (C, A, X, K, 3))
    _check(disp, "disp", torch.float64, (C, A, K, 3))
    _check(vmask, "vmask", torch.bool, (C, A, K))
    _check(rev, "rev", torch.int32, (C, A, R))
    _check(types, "types", torch.int32, (C, A))
    dev = g.device
    force = torch.empty((C, A, 3, ntypes, X), dtype=torch.float64,
                        device=dev)
    virial = torch.empty((C, 6, ntypes, X), dtype=torch.float64, device=dev)
    _launch("pair_scatter_rows", dev, _ptr(g), _ptr(disp), _ptr(vmask),
            _ptr(rev), _ptr(types), C, A, X, K, R, ntypes, _ptr(force),
            _ptr(virial))
    pair_scatter_rows.launches += 1
    return force, virial


pair_scatter_rows.launches = 0

KERNELS = (pair_u_duals, zlist, dbdd, pair_scatter_rows)


def reset_launches():
    """Set every kernel's launch count to 0."""
    for k in KERNELS:
        k.launches = 0


def launches():
    """{kernel name: launches since the last reset}."""
    return {k.__name__: k.launches for k in KERNELS}
