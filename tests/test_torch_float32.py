"""The float32 streamed linear SNAP fit of fitsnap_tpu_torch against the
JAX package's at float32 (CPU; the JAX side accumulates its normal
equations at float64, as tests/conftest.py enables it).

The same numpy inputs, made from seeds, go through both packages: six Ta
cells of 2 and 16 atoms (twojmax 6, the ZBL reference) packed by
`pack_batch_pos(..., dtype=np.float32)` into two chunks, through K8 (hi/lo
positions), K8r, the rows (K1-K5) and K7 (the kernels' plain versions on
the CPU):

- K8's plain version on a 30-atom cell moved to 40-50 A coordinates (the
  JAX test `tests/test_device_neighbors.py`'s case): mask and jidx equal
  to JAX's, disp within 1e-6 A of JAX's and of the float64 host lists; the
  float32 bin grid of its kernel (`k8_grid(..., np.float32)`) covers every
  neighbor;
- the rows (energy columns, force and virial rows, the three reference
  terms) are float32, each within 1e-5 of its column's largest magnitude
  in JAX's;
- AtA and Atb are float64, within 1e-5 of their largest magnitude, nrows
  exact;
- `fit_refined`'s coefficients are within 100 cond(A_w) 2^-23 (relative,
  in norm) of JAX's float32 fit and of the port's own float64 fit, cond
  that of the weighted rows with their columns scaled to unit norm (the
  system `NormalSolver` solves);
- `build_eval_fn`'s sums are within 1e-4 relative of JAX's;
- every output of the path's wrappers is float32 (K7's direct mode
  float64) and so is every table they are handed (`SnapParams.cast`, the
  ZBL table, the kernels' host plans);
- the modes outside the slice refuse float32 with their ROADMAP.md queue
  item, and float16 and mixed types are refused.

Largest differences measured on this set (this file, CPU): K8 disp 0
against JAX (the same TwoSum chain in the same order) and 2.4e-7 A
against the float64 lists; rows 3.1e-6 of a column's largest magnitude
(the force rows); AtA 3.8e-7, Atb 2.5e-7 (1.8e-7 and 2.9e-7 against the
port's float64 system); coefficients 7.0e-5 of JAX's and 6.2e-5 of the
float64 fit's, against a bound of 0.107 (cond 8,954); the MAE sums
2.1e-5 (energy) and 5.4e-7 (forces).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitsnap_tpu.fitsnap import FitSnap as JaxFitSnap
from fitsnap_tpu.ops.neighbors import host_neighbors
from fitsnap_tpu.parallel import fit as jfit
from fitsnap_tpu_torch import FitSnap
from fitsnap_tpu_torch.calculators.snap import snap_rows
from fitsnap_tpu_torch.kernels import launch as kl
from fitsnap_tpu_torch.kernels import snap_kernels as sk
from fitsnap_tpu_torch.ops import refpot
from fitsnap_tpu_torch.parallel import fit
from fitsnap_tpu_torch.tools import synthetic

F32 = torch.float32
FLAGS = {"energy": True, "force": True, "stress": True}
ROW_KEYS = ("e_cols", "force_rows", "virial_rows", "ref_e", "ref_f", "ref_v")


def t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def rel(port, ref):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


def split(x, dtype=np.float32):
    hi = np.asarray(x, dtype)
    return hi, np.asarray(x - hi.astype(np.float64), dtype)


# ---------------------------------------------------------------------------
# K8 at 40-50 A coordinates
# ---------------------------------------------------------------------------


def far_cell():
    """The JAX test's case: 30 atoms of a random triclinic cell moved to
    40-50 A coordinates, cutoff 5 A."""
    rng = np.random.default_rng(7)
    cell = np.triu(rng.uniform(4, 11, (3, 3)))
    cell[0, 1] *= 0.3
    cell[0, 2] *= 0.3
    cell[1, 2] *= 0.3
    pos = rng.uniform(0, 1, (30, 3)) @ cell.T + 40.0
    return pos, cell, 30, 5.0


@pytest.fixture(scope="module")
def far():
    pos, cell, na, cut = far_cell()
    dh, jh, mh, kh = host_neighbors(pos, cell, na, cut)
    ph, pl = split(pos)
    sv = np.asarray(fit.batch_shift_table([cell], cut), np.float64) @ cell.T
    sh, sl = split(sv)
    port = sk.device_neighbors(t(ph)[None], t(pl)[None], t(sh)[None],
                               t(sl)[None], t([na], torch.int32), cut, kh)
    ref = jfit.device_neighbors(jnp.asarray(ph), jnp.asarray(pl),
                                jnp.asarray(sh), jnp.asarray(sl), na, cut,
                                kh)
    return {"port": port, "jax": [np.asarray(x) for x in ref],
            "host": (dh, mh), "na": na}


def test_k8_plain_matches_jax_at_50_angstrom(far):
    """Mask and jidx equal to JAX's, disp float32 within 1e-6 A of JAX's
    (both rebuild it from the hi/lo parts by the same TwoSum chain)."""
    disp, jidx, mask = far["port"]
    dr, jr, mr = far["jax"]
    assert disp.dtype == F32 and dr.dtype == np.float32
    np.testing.assert_array_equal(mask[0].numpy(), mr)
    np.testing.assert_array_equal(jidx[0].numpy(), jr)
    assert np.abs(disp[0].numpy().astype(np.float64)
                  - dr.astype(np.float64)).max() <= 1e-6


def test_k8_plain_matches_float64_lists_at_50_angstrom(far):
    """Each atom's displacements within 1e-6 A of the float64 host lists
    (a float32 sum of the hi parts alone is off by about 2e-6 A there)."""
    disp, _, mask = far["port"]
    dh, mh = far["host"]
    dp, mp = disp[0].numpy().astype(np.float64), mask[0].numpy()
    for a in range(far["na"]):
        hs = np.array(sorted(map(tuple, dh[a][mh[a]])))
        ds = np.array(sorted(map(tuple, dp[a][mp[a]])))
        assert hs.shape == ds.shape
        assert np.abs(hs - ds).max() <= 1e-6


@pytest.mark.parametrize("case", ["far", "sparse"])
def test_k8_float32_bins_cover_every_neighbor(case):
    """K8's float32 grid (`k8_grid` at np.float32, op for op as its bin
    pass computes it, with the wider side K8_BIN_SIDE_F32): every real atom
    lies on it, and every atom j whose pos_j + svec_s lies within the
    cutoff of pos_i (d2 in float32 on the hi parts, as the kernel computes
    it) is in the bins searched for the float32 query point pos_i -
    svec_s."""
    if case == "far":
        pos, cell, na, cut = far_cell()
        H = sk.k8_bins(na)
    else:
        pos = np.array([[40.1, 40.1, 40.1], [60.0, 70.0, 75.0]])
        cell, na, cut, H = np.eye(3) * 40.0, 2, 4.8, 64
    f = np.float32
    ph = pos.astype(f)
    sv = (np.asarray(fit.batch_shift_table([cell], cut), np.float64)
          @ cell.T).astype(f)
    grid = sk.k8_grid(ph, na, cut, H, np.float32)
    assert grid[0].dtype == f and np.prod(grid[2]) <= H
    ab = sk.k8_bin_coords(ph[:na], grid)
    assert (ab >= 0).all() and (ab <= grid[2] - 1).all()
    found = 0
    for i in range(na):
        lo, hi = sk.k8_near_bins(ph[i] - sv, grid)
        diff = (ph[None, :na, :] + sv[:, None, :]) - ph[i]
        d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) \
            + diff[..., 2] * diff[..., 2]
        s_near, j_near = np.nonzero(d2 < f(cut * cut))
        found += len(s_near)
        assert (ab[j_near] >= lo[s_near]).all()
        assert (ab[j_near] <= hi[s_near]).all()
    assert found > 0 or case == "sparse"


# ---------------------------------------------------------------------------
# the streamed fit at float32
# ---------------------------------------------------------------------------


def write_configs(root):
    """Three 2-atom and three 16-atom bcc Ta cells, jittered and strained,
    with seeded truths (the float64 streamed test's set)."""
    rng = np.random.default_rng(21)
    for group, reps in (("Small", (1, 1, 1)), ("Super", (2, 2, 2))):
        (root / group).mkdir()
        for i in range(3):
            pos, cell0 = synthetic.supercell(synthetic.BCC,
                                             rng.uniform(3.15, 3.45), reps)
            cell = synthetic.strained(cell0, rng, 0.04)
            pos = pos @ np.linalg.solve(cell0, cell)
            pos = pos + rng.normal(0.0, 0.12, pos.shape)
            n = len(pos)
            st = rng.normal(0.0, 2e3, (3, 3))
            (root / group / f"{group}_{i}.json").write_text(
                synthetic.config_json(
                    pos, cell, energy=-11.8 * n + rng.normal(0.0, 0.5),
                    forces=rng.normal(0.0, 0.3, (n, 3)),
                    stress=0.5 * (st + st.T)))


@pytest.fixture(scope="module")
def f32(tmp_path_factory):
    root = tmp_path_factory.mktemp("f32")
    data = root / "JSON"
    data.mkdir()
    write_configs(data)
    s = synthetic.ta_settings(data, groups=[])
    s["GROUPS"].update({"Small": "1.0 0.0 100.0 1.0 1e-4",
                        "Super": "1.0 0.0 30.0 2.0 1e-3"})
    cwd = os.getcwd()
    os.chdir(root)
    try:
        fs = FitSnap(s, arglist=["--overwrite"], device="cpu")
        jfs = JaxFitSnap(s, arglist=["--overwrite"])
        fs.scrape_configs()
        jfs.scrape_configs()
    finally:
        os.chdir(cwd)
    calc, jcalc = fs.calculator, jfs.calculator
    packed = [calc._pack(d) for d in fs.data]
    g = fit.plan_pos_buckets(packed, calc.cutoff, max_programs=1)[0]
    batch = fit.pack_batch_pos(g["configs"], g["a_pad"], 6, g["s_table"],
                               np.float32, chunks=2)
    batch64 = fit.pack_batch_pos(g["configs"], g["a_pad"], 6, g["s_table"],
                                 np.float64, chunks=2)
    nb = {"cutoff": calc.cutoff, "k_pad": g["k_pad"]}
    args = (calc.params, 1, FLAGS)
    jargs = (jcalc.params, 1, FLAGS, jfit.make_mesh(1))
    kw = dict(device="cpu", refspec=calc.refspec, neighbors=nb)
    jkw = dict(refspec=jcalc.refspec, neighbors=nb)
    step = fit.build_step_fn(*args, **kw)
    res = fit.build_residual_fn(*args, **kw)
    jstep = jfit.build_step_fn(*jargs, **jkw)
    jres = jfit.build_residual_fn(*jargs, **jkw)
    out = {"calc": calc, "batch": batch, "nb": nb, "g": g,
           "step": step(batch), "jstep": jstep(batch),
           "step64": step(batch64)}
    out["fit"] = fit.fit_refined(step, res, batch)
    out["jfit"] = jfit.fit_refined(jstep, jres, batch)
    out["fit64"] = fit.fit_refined(step, res, batch64)
    x = np.asarray(out["jfit"][0])
    out["eval"] = fit.build_eval_fn(*args, **kw)(x, batch)
    out["jeval"] = [float(v) for v in jfit.build_eval_fn(*jargs, **jkw)(
        jnp.asarray(x, jnp.float32), batch)]

    # the rows of chunk 0, from the port's float32 lists, in both packages
    ph, pl, sh, sl, types, nat, cell = (t(x[0]) for x in batch[:7])
    disp, jidx, mask = sk.device_neighbors(ph, pl, sh, sl, nat, nb["cutoff"],
                                           nb["k_pad"])
    rev, _ = sk.reverse_table(jidx, mask)
    out["chunk"] = (disp, jidx, mask, rev, types, nat, cell)
    out["rows"] = snap_rows(calc.params, 1, calc.refspec, disp, jidx, mask,
                            rev, types, nat, cell)
    C, A = types.shape
    rows_fn = jcalc._rows_fn(g["a_pad"], nb["k_pad"], jnp.dtype(np.float32))
    out["jrows"] = {k: np.asarray(v) for k, v in rows_fn(
        disp.numpy(), jidx.numpy(), mask.numpy(), types.numpy(), nat.numpy(),
        cell.numpy(), np.zeros((C, A, 3), np.float32),
        np.zeros((C, A), np.float32)).items()}
    return out


@pytest.mark.parametrize("key", ROW_KEYS)
def test_rows_match_jax(f32, key):
    """Each row tensor float32, within 1e-5 of its column's largest
    magnitude in JAX's (a column: the last axis of the rows, the whole of a
    reference term)."""
    port, ref = f32["rows"][key], f32["jrows"][key]
    assert port.dtype == F32 and ref.dtype == np.float32
    assert tuple(port.shape) == ref.shape
    ncol = ref.shape[-1] if key in ROW_KEYS[:3] else 1
    p = port.numpy().astype(np.float64).reshape(-1, ncol)
    r = ref.astype(np.float64).reshape(-1, ncol)
    scale = np.abs(r).max(0)
    assert (scale > 0).all()
    assert (np.abs(p - r).max(0) / scale).max() <= 1e-5


def test_normal_equations_match_jax(f32):
    """AtA and Atb float64, within 1e-5 of their largest magnitude; nrows
    exact; the float32 system within 1e-5 of the float64 one too."""
    AtA, Atb, nrows = f32["step"]
    jAtA, jAtb, jn = f32["jstep"]
    assert AtA.dtype == Atb.dtype == np.float64
    assert AtA.shape == (31 * 31,) and Atb.shape == (31,)
    assert rel(AtA, jAtA) <= 1e-5 and rel(Atb, jAtb) <= 1e-5
    assert nrows == float(np.asarray(jn)) == 3 * 13 + 3 * 55
    assert rel(AtA, f32["step64"][0]) <= 1e-5
    assert rel(Atb, f32["step64"][1]) <= 1e-5


# a float32 fit's distance from a float64 or JAX fit, relative, beside the
# cond bound (which passes 1 at cond 9.4e4)
BETA_RTOL32 = 1e-3


def cond_w(AtA):
    """cond of the weighted rows with unit-norm columns: the square root of
    the equilibrated normal matrix's (the system NormalSolver solves)."""
    AtA = np.asarray(AtA, np.float64).reshape(31, 31)
    d = np.sqrt(np.diag(AtA))
    ev = np.linalg.eigvalsh(AtA / d[:, None] / d[None, :])
    return float(np.sqrt(ev[-1] / ev[0]))


@pytest.mark.parametrize("other", ["jfit", "fit64"])
def test_fit_refined_within_float32_bound(f32, other):
    """The refined float32 coefficients within 100 cond(A_w) 2^-23 of JAX's
    float32 fit and of the port's float64 fit (relative, in norm), and
    within BETA_RTOL32 of each (measured: 7.0e-5 and 6.2e-5)."""
    x = np.asarray(f32["fit"][0], np.float64)
    y = np.asarray(f32[other][0], np.float64)
    bound = 100.0 * cond_w(f32["step64"][0]) * 2.0 ** -23
    err = np.linalg.norm(x - y) / np.linalg.norm(y)
    assert np.isfinite(x).all()
    assert err <= bound
    assert err <= BETA_RTOL32
    assert f32["fit"][2] == f32[other][2]


def test_eval_sums_match_jax(f32):
    """build_eval_fn's sums (at float32, coefficients rounded to it) within
    1e-4 relative of JAX's; the counts exact."""
    se, ne, sf, nf = f32["eval"]
    jse, jne, jsf, jnf = f32["jeval"]
    assert (ne, nf) == (jne, jnf) == (6.0, 3 * (3 * 2 + 3 * 16))
    assert abs(se - jse) <= 1e-4 * jse and abs(sf - jsf) <= 1e-4 * jsf


# ---------------------------------------------------------------------------
# types: nothing on the path widens silently
# ---------------------------------------------------------------------------


def test_path_outputs_and_tables_are_float32(f32):
    """Every wrapper of the path, at the float32 chunk: K8 (disp), K1 (J,
    ut), K2 (z), K3 (B, dB/dD), K4 (force and virial rows), K5 (energy,
    forces, virial) come out float32, K7 float64 (direct) and float32 (the
    residual mode's A^T r); every table they read is float32."""
    calc = f32["calc"]
    p = calc.params.cast(F32)
    disp, jidx, mask, rev, types, nat, cell = f32["chunk"]
    assert disp.dtype == F32 and p.dtype == F32 and calc.params.cast(F32) is p
    for name in ("radelem", "wj", "elem", "selfvec", "bzero", "mmat", "y_fac",
                 "z_c", "L", "qcoef"):
        assert getattr(p, name).dtype == F32, name
        assert torch.equal(getattr(p, name),
                           getattr(calc.params, name).to(F32)), name
    assert sk.dbdd_tables(p).tg_fac.dtype == F32
    assert torch.equal(sk.dbdd_tables(p).tg_fac,
                       sk.dbdd_tables(calc.params).tg_fac.to(F32))
    assert sk.pair_u_tables(p, 1).blob.dtype == F32
    table = refpot.zbl_table(calc.refspec.zbl, "cpu", F32)
    assert table.dtype == F32 and torch.equal(
        table, refpot.zbl_table(calc.refspec.zbl, "cpu").to(F32))

    C, A, K = mask.shape
    flat = (disp.reshape(C * A, K, 3), types.reshape(C * A))
    jelem = torch.gather(types, 1, jidx.long().reshape(C, A * K)) \
        .reshape(C * A, K)
    smask = mask.reshape(C * A, K)
    J, ut = sk.pair_u_duals(flat[0], jelem, smask, flat[1], p)
    zr, zi = sk.zlist(ut, p)
    B, G = sk.dbdd(ut, zr, zi, J, p)
    force, vir = sk.pair_scatter_rows(G.reshape(C, A, -1, K, 3), disp, mask,
                                      rev, types, 1)
    e, fo, v = sk.zbl_eav(disp, jidx, mask, rev, types, table,
                          calc.refspec.zbl.cut_inner,
                          calc.refspec.zbl.cut_outer)
    for x in (J, ut, zr, zi, B, G, force, vir, e, fo, v):
        assert x.dtype == F32
    rows = f32["rows"]
    batch = [t(x[0]) for x in f32["batch"]]
    truths, weights = batch[7:10], batch[10:13]
    AtA, Atb, n = sk.normal_contrib(rows, truths, weights, nat, types, 1,
                                    True, FLAGS)
    assert AtA.dtype == Atb.dtype == n.dtype == torch.float64
    coeff = torch.as_tensor(f32["fit"][0], dtype=torch.float64)
    _, Atr, _ = sk.normal_contrib(rows, truths, weights, nat, types, 1, True,
                                  FLAGS, coeff, with_ata=False)
    assert Atr.dtype == F32


@pytest.mark.parametrize("queue", ["QUEUE_NN", "QUEUE_ACE", "QUEUE_CHEM",
                                   "QUEUE_LARGE", "QUEUE_SPATIAL"])
def test_off_path_refusal_names_the_queue(queue):
    """A float32 input where a mode has float64 only is refused with the
    ROADMAP.md queue item that ports it; float64 passes."""
    x = torch.zeros((2, 3), dtype=F32)
    with pytest.raises(TypeError, match="ROADMAP.md") as err:
        kl.check(x, "x", torch.float64, (2, 3), queue=getattr(kl, queue))
    assert getattr(kl, queue) in str(err.value)
    kl.check(x.double(), "x", torch.float64, (2, 3), queue=getattr(kl, queue))


def test_float16_and_mixed_types_are_refused(f32):
    """`float_type` takes all float64 or all float32 only; the plan has no
    float16 copy; the spatial rows refuse float32 with their queue."""
    a32, a64 = torch.zeros(2, dtype=F32), torch.zeros(2, dtype=torch.float64)
    assert kl.float_type("k", a32, a32) == F32
    for bad in ((a32, a64), (a32.half(),), (a32.bfloat16(), a32)):
        with pytest.raises(TypeError, match="all float64 or all float32"):
            kl.float_type("k", *bad)
    with pytest.raises(TypeError, match="float16"):
        f32["calc"].params.cast(torch.float16)
    rows = fit.build_spatial_rows_fn(f32["calc"].params, 1, FLAGS,
                                     device="cpu")
    disp, jidx, mask, _, types, nat, cell = (x[0] for x in f32["chunk"])
    with pytest.raises(TypeError, match=kl.QUEUE_SPATIAL):
        rows(disp, jidx, mask, types, nat, cell, np.float32(0.0),
             np.zeros((len(types), 3), np.float32),
             np.zeros(6, np.float32), 1.0, 1.0, 1.0)
