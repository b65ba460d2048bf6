"""fitsnap_tpu_torch's ZBL reference potential (kernel K5, `zbl_eav`)
against fitsnap_tpu (CPU, float64).

Five cases, each a batch of configs with host neighbor lists at 5.4 A and
the reverse table of their mask, ZBL between 4.0 and 4.8 A:

- `two_types`: three 12-atom liquid cells of two types whose Z differ
  (73 / 41), every type pair with coefficients;
- `one_sided`: the same cells with slots masked on one side of their pair
  only (the pair's reverse slot stays listed);
- `self_image`: two 2-atom cells small enough that each atom meets its own
  periodic images (the reverse table repeats those slots);
- `no_coeff`: two types without coefficients for the 2-2 pair;
- `padding`: cells of 5 and 9 atoms padded to 10 atom slots, so every
  config has a fully masked padding atom.

`reference_eav` (through `zbl_eav`, its plain version on CPU tensors, and
with `plain=True`) equals JAX `reference_eav` config by config: energy,
forces and virial within 1e-12 relative to each array's largest magnitude
(the packages sum in other orders).  A numpy emulation of the kernel's
scheme (two warps an atom, its own slots and then its reverse slots lane by
lane, each reverse slot's gradient recomputed from that slot's own
displacement and type pair, each warp's lanes summed by the xor
butterfly, an atom's two warps and the block's warps in order, each
config's blocks in order) equals the plain version on the same cases,
1e-12.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitsnap_tpu.ops import refpot as jrefpot
from fitsnap_tpu_torch.kernels import snap_kernels as sk
from fitsnap_tpu_torch.ops import neighbors, refpot
from fitsnap_tpu_torch.tools import synthetic

RTOL = 1e-12
LIST_CUTOFF = 5.4
ALL_PAIRS = ["pair_coeff 1 1 zbl 73 73", "pair_coeff 1 2 zbl 73 41",
             "pair_coeff 2 2 zbl 41 41"]
CASES = {
    "two_types": ALL_PAIRS,
    "one_sided": ALL_PAIRS,
    "self_image": ALL_PAIRS,
    "no_coeff": ALL_PAIRS[:2],
    "padding": ALL_PAIRS,
}


def t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def rel(port, ref):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


def case_cells(name, rng):
    """[(positions, cell, types)] of a case."""
    if name == "self_image":
        return [(rng.uniform(0, 3.1, (2, 3)), np.diag([3.1, 3.2, 3.0]),
                 np.array([0, 1], np.int32)),
                (rng.uniform(0, 2.9, (2, 3)), np.diag([2.9, 3.3, 3.1]),
                 np.array([1, 1], np.int32))]
    sizes = [5, 9] if name == "padding" else [12, 12, 12]
    out = []
    for na in sizes:
        pos, rows = synthetic.liquid(rng, na, 0.06, 1.5)
        out.append((pos, rows.T, (np.arange(na) % 2).astype(np.int32)))
    return out


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """(name, port spec, JAX spec, batch (disp, jidx, mask, rev, types) as
    numpy, natoms)."""
    name = request.param
    section = SimpleNamespace(lmp_pairdecl=[
        "pair_style hybrid/overlay zero 10.0 zbl 4.0 4.8",
        "pair_coeff * * zero"] + CASES[name])
    spec = refpot.parse_reference(section, 2)
    jspec = jrefpot.parse_reference(section, 2)
    rng = np.random.default_rng(21)
    cells = case_cells(name, rng)
    natoms = [len(p) for p, _, _ in cells]
    A = max(natoms) + (1 if name == "padding" else 0)
    K = max(neighbors.count_neighbors(p, c, len(p), LIST_CUTOFF)
            for p, c, _ in cells)
    disp, jidx, mask, types = [], [], [], []
    for pos, cell, ty in cells:
        d, j, m, _ = neighbors.host_neighbors(pos, cell, len(pos),
                                              LIST_CUTOFF, a_pad=A, k_pad=K)
        disp.append(d)
        jidx.append(j)
        mask.append(m)
        types.append(np.pad(ty, (0, A - len(ty))))
    disp, jidx, mask = np.stack(disp), np.stack(jidx), np.stack(mask)
    types = np.stack(types)
    if name == "one_sided":
        # drop some listed slots whose pair stays listed from the other side
        ci, ii, kk = np.nonzero(mask)
        pick = rng.choice(len(ci), size=len(ci) // 6, replace=False)
        mask[ci[pick], ii[pick], kk[pick]] = False
    rev = sk.reverse_table_plain(t(jidx, torch.int32), t(mask))[0].numpy()
    r = np.linalg.norm(disp[mask], axis=-1)
    assert ((r > 4.0) & (r < 4.8)).any() and r.max() > 4.8
    if name == "self_image":
        self_slot = jidx == np.arange(A)[None, :, None]
        assert (self_slot & mask).any()
    if name == "padding":
        assert all(not mask[c, na:].any() for c, na in enumerate(natoms))
    if name == "no_coeff":
        pair_t = types[np.arange(len(types))[:, None, None], jidx]
        assert (mask & (types[:, :, None] == 1) & (pair_t == 1)).any()
    return name, spec, jspec, (disp, jidx, mask, rev, types), natoms


def port_args(batch, spec):
    disp, jidx, mask, rev, types = batch
    table = refpot.zbl_table(spec.zbl, "cpu")
    return (t(disp), t(jidx, torch.int32), t(mask), t(rev, torch.int32),
            t(types, torch.int32), table, spec.zbl.cut_inner,
            spec.zbl.cut_outer)


def test_reference_eav_matches_jax(case):
    name, spec, jspec, batch, natoms = case
    disp, jidx, mask, rev, types = batch
    sk.reset_launches()
    outs = [refpot.reference_eav(*(t(x) for x in batch[:3]),
                                 t(rev, torch.int32), t(types, torch.int32),
                                 spec, plain=plain) for plain in (False, True)]
    outs.append(sk.zbl_eav(*port_args(batch, spec)))
    assert sk.launches()["zbl_eav"] == 0
    for c, na in enumerate(natoms):
        je, jf, jv = jrefpot.reference_eav(
            jnp.asarray(disp[c]), jnp.asarray(jidx[c]), jnp.asarray(mask[c]),
            jnp.asarray(types[c]), na, jspec)
        assert abs(float(je)) > 0 and np.abs(np.asarray(jf)).max() > 0
        for energy, force, virial in outs:
            assert rel(energy[c], je) <= RTOL
            assert rel(force[c], jf) <= RTOL
            assert rel(virial[c], jv) <= RTOL
    if name == "one_sided":
        # the case needs the reverse slots: twice the own rows' sums differ
        g, _ = sk.zbl_pair_grad_plain(*port_args(batch, spec)[:3],
                                      t(types, torch.int32),
                                      refpot.zbl_table(spec.zbl, "cpu"),
                                      spec.zbl.cut_inner, spec.zbl.cut_outer)
        assert rel(2.0 * g.sum(2), outs[1][1]) > 1e-3
    if name == "padding":
        for _, force, _ in outs:
            assert all((force[c, na:] == 0).all()
                       for c, na in enumerate(natoms))


# ---------------------------------------------------------------------------
# the kernel's scheme in numpy
# ---------------------------------------------------------------------------

def pair_energy(p, r, cut_inner, cut_outer):
    """(e, e') of one slot from its table row (pre, a, sw3, sw4, sw5,
    active); None where the pair has no energy."""
    if p[5] == 0.0 or not r < cut_outer:
        return None
    pre, a = p[0], p[1]
    x = r / a
    phi = dphi = 0.0
    for c, d in zip(sk.ZBL_C, sk.ZBL_D):
        ex = np.exp(-d * x)
        phi += c * ex
        dphi -= c * d * ex
    dphi /= a
    e = pre / r * phi + p[4]
    de = pre * (-phi / (r * r) + dphi / r)
    if r > cut_inner:
        tt = r - cut_inner
        e += tt ** 3 * (p[2] + p[3] * tt)
        de += tt * tt * (3.0 * p[2] + 4.0 * p[3] * tt)
    return e, de


def butterfly(lanes):
    """Lane 0's sum of 32 lanes by the xor shuffles of csrc/zbl_pair.cu."""
    v = np.array(lanes, np.float64)
    idx = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[idx ^ off]
    return v[0]


def emulate_zbl_eav(disp, jidx, mask, rev, types, table, cut_inner,
                    cut_outer, wpa=2):
    """(energy, force, virial) in csrc/zbl_pair.cu's order of sums: `wpa`
    warps an atom, its lane L taking own slots L + 32 wpa u, then reverse
    slots L + 32 wpa u."""
    C, A, K = mask.shape
    R = rev.shape[2]
    W = sk.ZBL_ATOMS
    bpc = -(-A // W)
    stride = 32 * wpa
    energy, force, virial = np.zeros(C), np.zeros((C, A, 3)), np.zeros((C, 6))
    for c in range(C):
        part = np.zeros((bpc, 7))
        for b in range(bpc):
            red = np.zeros((W * wpa, 7))
            for a_ in range(W):
                i = b * W + a_
                sums = []
                for h in range(wpa):
                    lanes = np.zeros((32, 13))   # e, virial, own g, rev g
                    for lane in range(32 if i < A else 0):
                        acc = lanes[lane]
                        L = lane + 32 * h
                        for k in range(L, K, stride):
                            if not mask[c, i, k]:
                                continue
                            d = disp[c, i, k]
                            r = np.sqrt(d[0] * d[0] + d[1] * d[1]
                                        + d[2] * d[2])
                            p = table[types[c, i], types[c, jidx[c, i, k]]]
                            ed = pair_energy(p, r, cut_inner, cut_outer)
                            if ed is None:
                                continue
                            g = 0.5 * ed[1] / r * d
                            acc[0] += ed[0]
                            acc[1:7] -= (d[[0, 1, 2, 1, 0, 0]]
                                         * g[[0, 1, 2, 2, 2, 1]])
                            acc[7:10] += g
                        for q in range(L, R, stride):
                            slot = rev[c, i, q]
                            if slot < 0 or not mask[c].reshape(-1)[slot]:
                                continue
                            d = disp[c].reshape(-1, 3)[slot]
                            r = np.sqrt(d[0] * d[0] + d[1] * d[1]
                                        + d[2] * d[2])
                            p = table[types[c, slot // K], types[c, i]]
                            ed = pair_energy(p, r, cut_inner, cut_outer)
                            if ed is not None:
                                acc[10:13] += 0.5 * ed[1] / r * d
                    tot = butterfly(lanes)
                    red[a_ * wpa + h] = tot[:7]
                    sums.append(tot[7:13])
                if i < A:
                    own = sum((t_[:3] for t_ in sums), np.zeros(3))
                    rv = sum((t_[3:] for t_ in sums), np.zeros(3))
                    force[c, i] = own - rv
            for w in range(W * wpa):
                part[b] += red[w]
        sums = [butterfly([sum(part[q::32][:, v], 0.0) if q < bpc else 0.0
                           for q in range(32)]) for v in range(7)]
        energy[c] = 0.5 * sums[0]
        virial[c] = sums[1:]
    return energy, force, virial


def test_kernel_scheme_matches_plain(case):
    """The kernel's order of sums, with every reverse slot's gradient
    recomputed from its own displacement, equals the plain version (the
    per-slot gradient, then K4's plain scatter at width 1)."""
    _, spec, _, batch, _ = case
    args = port_args(batch, spec)
    ref = sk.zbl_eav_plain(*args)
    out = emulate_zbl_eav(*batch, refpot.zbl_table(spec.zbl, "cpu").numpy(),
                          spec.zbl.cut_inner, spec.zbl.cut_outer)
    for o, r in zip(out, ref):
        assert rel(o, r) <= RTOL
