"""quadraticflag and chemflag (explicit multi-element SNAP) in
fitsnap_tpu_torch against fitsnap_tpu (CPU, float64).

- The SNAP plan of `ops/cg.build_snap_plan` (nb_base, the quadratic pairs
  iq1/iq2 with qcoef, bzero) and the BISPECTRUM section's blist, blank2J
  and ncoeff for each flag and for both, exactly.
- The plain versions against their JAX twins on the same numpy inputs:
  `_utot_from_wu` with element channels (wselfallflag 0 and 1),
  `_chem_b_and_dbdu`, `_quad_chain`.
- `descriptors_with_jacobian` and the recursion oracle `atom_descriptors`
  for quadratic SNAP at twojmax 6 (495 columns) and at twojmax 8 (1,595
  columns, A = 8, K = 16: its JAX compile takes about 30 s), chemflag at
  twojmax 4 with two elements and bnormflag (wselfallflag 0 and 1), and
  quadratic x chemflag at twojmax 2 on the inputs of
  `tests/test_snap_oracle.py:165-176`; on the same inputs the pair-grid
  descriptors `atom_descriptors_fast` (element channels, quadratic
  columns).
- On CPU tensors the chemflag and K6q wrappers return their plain
  versions' results and launch nothing.
- At the published widths (Ta_Quadratic 1,596 columns, InP 480) the
  calculators' row width and blank2J equal the JAX package's, and K3's W
  tiles are those its source describes; K3's compact y targets rebuild
  the y-list of the JAX package (the plain version at twojmax 8).

Tolerance: 1e-12 relative to the largest magnitude of each array (the two
packages sum in different orders at float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitsnap_tpu.config import Config as JaxConfig
from fitsnap_tpu.ops import snap as jsnap
from fitsnap_tpu.ops.cg import build_snap_plan as jax_plan
from fitsnap_tpu_torch.config import Config
from fitsnap_tpu_torch.convert import (PARAM_FIELDS, PLAN_FIELDS,
                                       snap_params_from_numpy)
from fitsnap_tpu_torch.kernels import launch as kl
from fitsnap_tpu_torch.kernels import snap_kernels as sk
from fitsnap_tpu_torch.ops import snap as tsnap
from fitsnap_tpu_torch.ops.cg import build_snap_plan
from fitsnap_tpu_torch.tools import synthetic

RTOL = 1e-12

PLANS = {
    "quadratic": dict(twojmax=4, nelements=1, quadraticflag=True,
                      bzeroflag=False),
    "chem_wself0": dict(twojmax=4, nelements=2, chemflag=True,
                        bnormflag=True, bzeroflag=True),
    "chem_wself1": dict(twojmax=4, nelements=2, chemflag=True,
                        bnormflag=True, bzeroflag=True, wselfallflag=True),
    "chem_bnorm0": dict(twojmax=3, nelements=3, chemflag=True,
                        bzeroflag=True),
    "quadratic_chem": dict(twojmax=2, nelements=2, chemflag=True,
                           bzeroflag=True, quadraticflag=True),
}

# name: (JAX plan flags, numtypes, A, K, neighbor-block seed)
DESCRIPTORS = {
    "quadratic_tj6": (dict(twojmax=6, nelements=1, quadraticflag=True,
                           bzeroflag=False), 8, 24, 11),
    "quadratic_tj8": (dict(twojmax=8, nelements=1, quadraticflag=True,
                           bzeroflag=False), 8, 16, 12),
    "chem_tj4_wself0": (PLANS["chem_wself0"], 8, 24, 13),
    "chem_tj4_wself1": (PLANS["chem_wself1"], 8, 24, 13),
    "quadratic_chem_tj2": (PLANS["quadratic_chem"], 3, 6, 5),
}


def close(port, ref, rtol=RTOL):
    port = np.asarray(port.detach().cpu() if torch.is_tensor(port) else port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-300)
    err = np.abs(port - ref).max() / scale
    assert err <= rtol, f"relative error {err:.3e}"


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_fields(name):
    """The port's copy of the plan builder gives the JAX plan's chemflag and
    quadratic fields exactly."""
    flags = PLANS[name]
    port, ref = build_snap_plan(**flags), jax_plan(**flags)
    assert port.nb_base == ref.nb_base
    assert port.nb_base == ref.ntriples * (
        flags["nelements"] ** 3 if flags.get("chemflag") else 1)
    for field in ("iq1", "iq2", "qcoef", "bzero", "i1", "i2", "i3", "mmat",
                  "y_src", "y_fac"):
        np.testing.assert_array_equal(getattr(port, field),
                                      getattr(ref, field), err_msg=field)
    if flags.get("quadraticflag"):
        nb = port.nb_base
        assert len(port.iq1) == nb * (nb + 1) // 2
        assert (port.qcoef == np.where(port.iq1 == port.iq2, 0.5, 1.0)).all()


def section_settings(chemflag, quadraticflag, bzeroflag):
    s = synthetic.ta_settings("JSON", groups=[])
    s["BISPECTRUM"].update(numTypes=2, twojmax="4 4", wj="1.0 0.9",
                           radelem="0.5 0.45", type="In P",
                           chemflag=int(chemflag),
                           quadraticflag=int(quadraticflag),
                           bzeroflag=int(bzeroflag))
    s["ESHIFT"] = {"In": 0.0, "P": 0.0}
    return s


@pytest.mark.parametrize("chemflag,quadraticflag,bzeroflag", [
    (0, 1, 0), (1, 0, 1), (1, 0, 0), (1, 1, 1)])
def test_config_blist(chemflag, quadraticflag, bzeroflag):
    s = section_settings(chemflag, quadraticflag, bzeroflag)
    port = Config(s, ["--overwrite"]).sections["BISPECTRUM"]
    ref = JaxConfig(s, ["--overwrite"]).sections["BISPECTRUM"]
    assert port.ncoeff == ref.ncoeff
    assert port.blist == ref.blist
    np.testing.assert_array_equal(port.blank2J, ref.blank2J)
    plan = build_snap_plan(twojmax=4, nelements=2, chemflag=bool(chemflag),
                           quadraticflag=bool(quadraticflag))
    assert port.ncoeff == plan.ncoeff


@pytest.mark.parametrize("kind,width", [("quadratic", 1596), ("inp", 480)])
def test_full_width_calculators(kind, width, tmp_path):
    """At the published widths (Ta_Quadratic: twojmax 8, 1,595 descriptor
    columns; InP: two chemflag blocks of 240) the port's calculator gives
    the JAX calculator's row width and blank2J, and one 128-atom config per
    device batch at the quadratic width."""
    from fitsnap_tpu.calculators.snap import SnapCalculator as JaxCalculator
    from fitsnap_tpu_torch.calculators.snap import SnapCalculator, chunk_size

    make = {"quadratic": synthetic.quadratic_settings,
            "inp": synthetic.inp_settings}[kind]
    s = make(tmp_path)
    port = SnapCalculator("LAMMPSSNAP", Config(s, ["--overwrite"]), "cpu")
    ref = JaxCalculator("LAMMPSSNAP", JaxConfig(s, ["--overwrite"]))
    assert port.get_width() == ref.get_width() == width
    np.testing.assert_array_equal(port.sec.blank2J, ref.sec.blank2J)
    assert port.params.nb_base == {"quadratic": 55, "inp": 240}[kind]
    if kind == "quadratic":
        assert port.desc_width() == 1595
        assert chunk_size(128, 64, port.desc_width()) == 1


def jax_params(flags):
    nelem = flags["nelements"]
    return jsnap.SnapParams(
        plan=jax_plan(**flags), rcutfac=4.6, rfac0=0.99, rmin0=0.0,
        switchflag=True, switchinnerflag=False,
        wj=np.array([1.0, 0.93][:nelem]),
        radelem=np.array([0.5, 0.45][:nelem]))


def port_params(jp):
    d = {k: getattr(jp.plan, k) for k in PLAN_FIELDS}
    d.update({k: getattr(jp, k) for k in PARAM_FIELDS})
    return snap_params_from_numpy(d, "cpu")


def make_block(seed, nelem, A, K):
    """(disp, jelem, mask, ielem): pairs around 2 A along x (as
    `tests/test_snap_oracle.py`'s), masked pairs and a padded atom."""
    rng = np.random.default_rng(seed)
    disp = rng.normal(size=(A, K, 3)) * 1.2 + np.array([2.0, 0.0, 0.0])
    mask = np.ones((A, K), bool)
    if A > 3:
        mask = rng.uniform(size=(A, K)) < 0.85
        mask[-1] = False
    jelem = rng.integers(0, nelem, (A, K)).astype(np.int32)
    ielem = rng.integers(0, nelem, (A,)).astype(np.int32)
    return disp, jelem, mask, ielem


@pytest.fixture(scope="module", params=sorted(DESCRIPTORS))
def case(request):
    flags, A, K, seed = DESCRIPTORS[request.param]
    jp = jax_params(flags)
    block = make_block(seed, flags["nelements"], A, K)
    jargs = tuple(jnp.asarray(x) for x in block)
    targs = tuple(torch.from_numpy(x) for x in block)
    chem = bool(flags.get("chemflag"))
    small = flags["twojmax"] < 8

    def reference(disp, jelem, mask, ielem):
        wu, J = jsnap._pair_wu_duals(disp, jelem, mask, ielem, jp)
        ut = jsnap._utot_from_wu(wu, jelem, ielem, jp)
        B, dBdD = jsnap.descriptors_with_jacobian(disp, jelem, mask, ielem,
                                                  jp)
        out = dict(wu=wu, J=J, ut=ut, B=B, dBdD=dBdD)
        if small:
            # (with one element the JAX function takes one channel)
            out["B_oracle"] = jsnap.atom_descriptors(disp, jelem, mask,
                                                     ielem, jp)
            out["B_chem"], out["dbdu_chem"] = jsnap._chem_b_and_dbdu(
                ut, jp.plan)
        return out

    ref = {k: np.array(v) for k, v in jax.jit(reference)(*jargs).items()}
    return dict(name=request.param, jp=jp, p=port_params(jp), targs=targs,
                ref=ref, chem=chem)


def test_descriptors_with_jacobian(case):
    B, dBdD = tsnap.descriptors_with_jacobian(*case["targs"], case["p"])
    assert B.shape[1] == case["jp"].plan.ncoeff
    close(B, case["ref"]["B"])
    close(dBdD, case["ref"]["dBdD"])


def test_utot_from_wu(case):
    _, jelem, _, ielem = case["targs"]
    ut = tsnap._utot_from_wu(torch.from_numpy(case["ref"]["wu"]), jelem,
                             ielem, case["p"])
    close(ut, case["ref"]["ut"])


def test_atom_descriptors_oracle(case):
    """The recursion oracle agrees with the JAX oracle (not compiled at
    twojmax 8) and with the factorized path's B."""
    Bo = tsnap.atom_descriptors(*case["targs"], case["p"])
    if "B_oracle" in case["ref"]:
        close(Bo, case["ref"]["B_oracle"])
    close(Bo, case["ref"]["B"], rtol=1e-11)


def test_atom_descriptors_fast(case):
    """The pair-grid descriptors (`compute_utot_mono`, element channels
    under chemflag, the quadratic columns) agree with the JAX package's
    factorized B."""
    close(tsnap.atom_descriptors_fast(*case["targs"], case["p"]),
          case["ref"]["B"])


def test_chem_b_and_dbdu(case):
    """Against the JAX function; at twojmax 8 (not compiled there) the one
    channel case against the one-channel y-list and B of the port."""
    ut = torch.from_numpy(case["ref"]["ut"])
    p = case["p"]
    B, dbdu = tsnap._chem_b_and_dbdu(ut, p)
    if "B_chem" in case["ref"]:
        close(B, case["ref"]["B_chem"])
        close(dbdu, case["ref"]["dbdu_chem"])
    else:
        zcat = tsnap._compute_zcat(ut, p)
        close(B, tsnap._bispectrum_from_zcat(ut, zcat, p))
        close(dbdu[:, :, 0], tsnap._dbdu_ylist(ut, p, zcat))
        close(B, case["ref"]["B"][:, :p.nb_base])


def test_wrappers_take_plain_on_cpu(case):
    """On CPU tensors the wrappers of the path return their plain versions'
    results and launch nothing."""
    sk.reset_launches()
    p, targs = case["p"], case["targs"]
    jelem = targs[1]
    J, ut = (sk.pair_u_duals_chem if case["chem"] else sk.pair_u_duals)(
        *targs, p)
    J0, ut0 = sk.pair_u_duals_plain(*targs, p)
    assert torch.equal(J, J0) and torch.equal(ut, ut0)
    if case["chem"]:
        z = sk.zlist_chem(ut, p)
        assert all(torch.equal(a, b) for a, b in zip(
            z, sk.zlist_chem_plain(ut, p)))
        assert z[0].shape == (ut.shape[0], p.nchem ** 2, p.nz)
        out = sk.dbdd_chem(ut, *z, J, jelem, p)
        ref = sk.dbdd_chem_plain(ut, *z, J, jelem, p)
    else:
        z = sk.zlist(ut, p)
        out, ref = sk.dbdd(ut, *z, J, p), sk.dbdd_plain(ut, *z, J, p)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    if p.quadraticflag:
        q = sk.quad_chain(*out, p)
        assert all(torch.equal(a, b) for a, b in zip(
            q, sk.quad_chain_plain(*out, p)))
    assert set(sk.launches().values()) == {0}


@pytest.mark.parametrize("name", ["quadratic_tj6", "quadratic_chem_tj2"])
def test_quad_chain(name):
    """`_quad_chain` on random B and dB/dD (trailing axes K x 3) and on a
    jacobian with one trailing axis."""
    flags = DESCRIPTORS[name][0]
    jp = jax_params(flags)
    p = port_params(jp)
    rng = np.random.default_rng(9)
    W = jp.plan.nb_base
    B = rng.normal(size=(5, W))
    for tail in ((7, 3), (11,)):
        dB = rng.normal(size=(5, W) + tail)
        ref = jsnap._quad_chain(jnp.asarray(B), jnp.asarray(dB), jp.plan)
        out = tsnap._quad_chain(torch.from_numpy(B), torch.from_numpy(dB), p)
        for o, r in zip(out, ref):
            close(o, r)
    close(tsnap._quad_extend(torch.from_numpy(B), p),
          jsnap._quad_extend(jnp.asarray(B), jp.plan))


def test_dbdd_tiles():
    """K3's W tiles at 64 neighbor slots (rows 16 or 32, blocks per atom),
    each within half a card SM's shared memory so that two blocks share an
    SM: one tile of 32 rows at twojmax 6, four of 16 at twojmax 8, eight
    of 32 with the two channels of InP at twojmax 6."""
    jp8 = jax_params(DESCRIPTORS["quadratic_tj8"][0])
    jp6 = jax_params(dict(twojmax=6, nelements=1))
    inp = jax_params(dict(twojmax=6, nelements=2, chemflag=True,
                          bnormflag=True, wselfallflag=True))
    assert sk.dbdd_tiles(port_params(jp6)) == (32, 1)
    assert sk.dbdd_tiles(port_params(jp8)) == (16, 4)
    assert sk.dbdd_tiles(port_params(inp)) == (32, 8)
    for jp in (jp6, jp8, inp):
        p = port_params(jp)
        mt, tiles = sk.dbdd_tiles(p)
        assert mt * tiles >= p.nb_base > mt * (tiles - 1)
        ldl = kl.ag_ldl(2 * p.u_len)
        smem = (8 * mt * ldl + kl.AG_STAGE_BYTES + 4 * (2 * 64 + 2)
                + mt // 16 * (ldl // 8))
        assert smem <= kl.SMEM_PAIR


def test_dbdd_tables_give_ylist(case):
    """K3's compact y targets (`dbdd_tables`), emulated in numpy as the
    kernel reads them (per row and channel, the layer-order sum of
    factor x z over the layers of that channel), give the y-list of the
    JAX package's `_chem_b_and_dbdu` (one channel with one element), or of
    the plain `_dbdu_ylist` at twojmax 8, to 1e-12; every nonzero y_fac is
    a target."""
    p, ref = case["p"], case["ref"]
    tg = sk.dbdd_tables(p)
    ptr, tu = tg.tg_ptr.numpy(), tg.tg_u.numpy()
    src, fac = tg.tg_src.numpy(), tg.tg_fac.numpy()
    yfac = p.y_fac.numpy()
    assert len(tu) == int((yfac != 0).any(axis=0).sum())
    ut = torch.from_numpy(ref["ut"])
    nc, U, T = p.nchem, p.u_len, p.ntriples
    if case["chem"]:
        zr, zi = (z.numpy() for z in tsnap._compute_zcat_chem(ut, p))
    else:
        zr, zi = (z.numpy()[:, None] for z in tsnap._compute_zcat(ut, p))
    chan, pair = p.blk_chan.numpy(), p.blk_pair.numpy()
    y = np.zeros((len(ut), p.nb_base, nc, 2 * U))
    for w in range(p.nb_base):
        blk, tt = divmod(w, T)
        q = np.arange(ptr[tt], ptr[tt + 1])
        for ch in range(nc):
            yr = yi = 0.0
            for lay in range(3):
                if chan[blk, lay] == ch:
                    s = src[q, lay]
                    yr = yr + fac[q, lay] * zr[:, pair[blk, lay], s]
                    yi = yi + fac[q, lay] * zi[:, pair[blk, lay], s]
            y[:, w, ch, tu[q]] = yr
            y[:, w, ch, U + tu[q]] = yi
    if "dbdu_chem" in ref:
        close(y, ref["dbdu_chem"][:, :p.nb_base])
    else:
        close(y[:, :, 0], tsnap._dbdu_ylist(ut, p))
