"""fitsnap_tpu_torch.parallel.fit against fitsnap_tpu.parallel.fit (CPU,
float64).

The same numpy inputs, made from seeds, go through the JAX functions and
their port (kernels K5, K7, K8 and K8r through their plain versions on the
CPU):

- planners and packers (`batch_shift_table`, `plan_shift_groups`,
  `plan_pos_buckets`, `pack_batch_pos`, `pack_batch`): equal, exactly, on
  random triclinic cells of mixed sizes;
- K8 `device_neighbors`: mask equal, jidx equal where masked in, disp
  within 1e-12 A, on four random triclinic cells with padded atoms; on a
  perfect bcc supercell, where distances tie, each atom's set of
  displacements rounded to 1e-8;
- K8r `reverse_table`: equal to the host `reverse_neighbors`;
- K5 through `reference_eav`: the ZBL energy, forces and virial within
  1e-12 of the largest magnitude, with pairs from 1.5 A to past 4.8 A, one
  and two types;
- K7 through `config_normal_contrib`, one config at a time, with the
  reference and in the residual mode: AtA and Atb within 1e-12 relative to
  their largest magnitude, nrows exact;
- the streamed fit on six configs of at most 16 atoms in one planned group
  (twojmax 6): `build_step_fn` with `neighbors=` (direct and accumulating)
  and with host lists, and `build_residual_fn`, within 1e-12 relative,
  nrows exact,
  `fit_refined` coefficients within 1e-10, `build_eval_fn` MAE sums at the
  same coefficients within 1e-12 relative;
- the streamed step under chemflag (six 8-atom InP cells, two elements)
  and quadraticflag (the six Ta cells), twojmax 4: the system sized as
  the model's width, AtA and Atb within 1e-12 relative, nrows exact;
- `TpuSVD` and `TfSVD`: coefficients within 1e-10 on a seeded weighted
  system;
- a float32 batch (the packers default to float64) is refused by
  `put_batch` and the step.

The packages sum in different orders, hence relative tolerances at a few
hundred ulps; the coefficients carry the condition number of the system.
"""

import os
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitsnap_tpu.fitsnap import FitSnap as JaxFitSnap
from fitsnap_tpu.ops import refpot as jrefpot
from fitsnap_tpu.parallel import fit as jfit
from fitsnap_tpu.solvers.svd import TfSVD as JaxTfSVD
from fitsnap_tpu.solvers.tpu_svd import TpuSVD as JaxTpuSVD
from fitsnap_tpu_torch import FitSnap
from fitsnap_tpu_torch.kernels import snap_kernels as sk
from fitsnap_tpu_torch.ops import neighbors, refpot
from fitsnap_tpu_torch.parallel import fit
from fitsnap_tpu_torch.solvers.svd import TfSVD
from fitsnap_tpu_torch.solvers.tpu_svd import TpuSVD
from fitsnap_tpu_torch.tools import synthetic

RTOL = 1e-12
FLAGS = {"energy": True, "force": True, "stress": True}


def rel(port, ref):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


def t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def random_config(rng, na):
    """Random triclinic cell (upper-triangular columns) and positions."""
    cell = np.triu(rng.uniform(4, 11, (3, 3)))
    cell[0, 1] *= 0.3
    cell[0, 2] *= 0.3
    cell[1, 2] *= 0.3
    pos = rng.uniform(0, 1, (na, 3)) @ cell.T
    return pos, cell


def packed_config(rng, pos, cell, cutoff):
    """A packed config with host neighbor lists and seeded truths."""
    na = len(pos)
    disp, jidx, mask, kmax = neighbors.host_neighbors(pos, cell, na, cutoff)
    st = rng.normal(size=(3, 3))
    return SimpleNamespace(
        pos=pos, cell=cell, natoms=na, types=np.zeros(na, np.int32),
        disp=disp, jidx=jidx, mask=mask, kcount=kmax,
        data={"Energy": float(rng.normal()), "Forces": rng.normal(
            size=(na, 3)), "Stress": st + st.T, "eweight": 2.0,
              "fweight": 0.5, "vweight": 1e-3})


def mixed_configs():
    """Cells of 2-250 atoms, some scaled down so they need more images."""
    rng = np.random.default_rng(11)
    out = []
    for na, scale in [(12, 1.0), (2, 0.35), (20, 1.0)]:
        pos, cell = random_config(rng, na)
        cell = cell * scale
        pos = rng.uniform(0, 1, (na, 3)) @ cell.T
        out.append(packed_config(rng, pos, cell, 5.0))
    for na in [2, 4, 9, 17, 33, 65, 120, 250, 40, 70]:
        _, cell = random_config(rng, min(na, 40))
        cell = cell * (0.5 + 0.1 * na) ** (1 / 3)
        pos = rng.uniform(0, 1, (na, 3)) @ cell.T
        out.append(packed_config(rng, pos, cell, 5.0))
    return out


@pytest.fixture(scope="module")
def mixed():
    return mixed_configs()


# ---------------------------------------------------------------------------
# planners and packers
# ---------------------------------------------------------------------------


def same_groups(port, ref):
    assert len(port) == len(ref)
    for g, h in zip(port, ref):
        assert [id(pc) for pc in g["configs"]] == \
            [id(pc) for pc in h["configs"]]
        assert (g["a_pad"], g["k_pad"], g["s_table"]) == \
            (h["a_pad"], h["k_pad"], h["s_table"])


def test_batch_shift_table(mixed):
    cells = [pc.cell for pc in mixed]
    for sub in (cells[:1], cells[:3], cells):
        assert fit.batch_shift_table(sub, 5.0) == \
            jfit.batch_shift_table(sub, 5.0)


def test_plan_shift_groups(mixed):
    groups = fit.plan_shift_groups(mixed, 5.0)
    assert len(groups) >= 2
    same_groups(groups, jfit.plan_shift_groups(mixed, 5.0))


@pytest.mark.parametrize("max_programs", [1, 3, 10])
def test_plan_pos_buckets(mixed, monkeypatch, max_programs):
    monkeypatch.delenv("FITSNAP_TPU_PROGRAM_COST", raising=False)
    groups = fit.plan_pos_buckets(mixed, 5.0, max_programs=max_programs)
    assert len(groups) <= max_programs
    same_groups(groups, jfit.plan_pos_buckets(mixed, 5.0,
                                              max_programs=max_programs))


@pytest.mark.parametrize("dtype,chunks", [(np.float64, 1), (np.float64, 2),
                                          (np.float32, 2)])
def test_pack_batches(mixed, dtype, chunks):
    for g in fit.plan_shift_groups(mixed, 5.0):
        cfgs = g["configs"]
        n_pad = -(-len(cfgs) // chunks) * chunks
        port = fit.pack_batch_pos(cfgs, g["a_pad"], n_pad, g["s_table"],
                                  dtype, chunks=chunks)
        ref = jfit.pack_batch_pos(cfgs, g["a_pad"], n_pad, g["s_table"],
                                  dtype, chunks=chunks)
        k_pad = max(pc.kcount for pc in cfgs)
        port += fit.pack_batch(cfgs, g["a_pad"], k_pad, n_pad, dtype,
                               chunks=chunks)
        ref += jfit.pack_batch(cfgs, g["a_pad"], k_pad, n_pad, dtype,
                               chunks=chunks)
        assert len(port) == len(ref) == 25
        for x, y in zip(port, ref):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        if dtype == np.float64:
            assert not port[1].any() and not port[3].any()


# ---------------------------------------------------------------------------
# K8 and K8r
# ---------------------------------------------------------------------------

CUTOFF = 5.0


def triclinic_lists():
    """(pos, cell, natoms, k_pad) of four random triclinic cells, each with
    two padded atom rows and three slots past its largest count."""
    rng = np.random.default_rng(3)
    out = []
    for _ in range(4):
        na = int(rng.integers(4, 40))
        pos, cell = random_config(rng, na)
        kh = neighbors.count_neighbors(pos, cell, na, CUTOFF)
        out.append((np.concatenate([pos, np.zeros((2, 3))]), cell, na,
                    kh + 3))
    return out


def both_device_neighbors(pos, cell, na, k_pad, cutoff=CUTOFF):
    s_table = fit.batch_shift_table([cell], cutoff)
    sv = np.asarray(s_table, np.float64) @ cell.T
    zero_p, zero_s = np.zeros_like(pos), np.zeros_like(sv)
    port = fit.device_neighbors(t(pos)[None], t(zero_p)[None], t(sv)[None],
                                t(zero_s)[None], t([na], torch.int32),
                                cutoff, k_pad)
    ref = jfit.device_neighbors(jnp.asarray(pos), jnp.asarray(zero_p),
                                jnp.asarray(sv), jnp.asarray(zero_s), na,
                                cutoff, k_pad)
    return ([x[0].numpy() for x in port], [np.asarray(x) for x in ref])


@pytest.mark.parametrize("index", range(4))
def test_device_neighbors_match_jax(index):
    pos, cell, na, k_pad = triclinic_lists()[index]
    (dp, jp, mp), (dr, jr, mr) = both_device_neighbors(pos, cell, na, k_pad)
    np.testing.assert_array_equal(mp, mr)
    assert mp[:na].sum(1).max() == k_pad - 3 and not mp[na:].any()
    np.testing.assert_array_equal(jp[mp], jr[mr])
    assert np.abs(dp - dr).max() <= 1e-12


def test_device_neighbors_ties_on_bcc():
    """A perfect bcc supercell: every shell is a tie; each atom keeps the
    same set of displacements as the JAX function and the host lists."""
    pos, rows = synthetic.supercell(synthetic.BCC, 3.3, (2, 2, 2))
    cell = rows.T
    na = len(pos)
    kh = neighbors.count_neighbors(pos, cell, na, 4.8)
    (dp, jp, mp), (dr, _, mr) = both_device_neighbors(pos, cell, na, kh,
                                                      4.8)
    dh, _, mh, _ = neighbors.host_neighbors(pos, cell, na, 4.8)
    np.testing.assert_array_equal(mp, mr)
    for a in range(na):
        port = sorted(map(tuple, np.round(dp[a][mp[a]], 8)))
        assert port == sorted(map(tuple, np.round(dr[a][mr[a]], 8)))
        assert port == sorted(map(tuple, np.round(dh[a][mh[a]], 8)))


@pytest.mark.parametrize("index", range(5))
def test_reverse_table_matches_host(index):
    if index < 4:
        pos, cell, na, k_pad = triclinic_lists()[index]
        cut = CUTOFF
    else:
        pos, rows = synthetic.supercell(synthetic.BCC, 3.3, (1, 1, 1))
        cell, na, cut = rows.T, 2, 4.8
        k_pad = neighbors.count_neighbors(pos, cell, na, cut) + 5
    (_, jp, mp), _ = both_device_neighbors(pos, cell, na, k_pad, cut)
    rev, dropped = sk.reverse_table(t(jp)[None], t(mp)[None])
    assert int(dropped[0]) == 0
    ref = neighbors.reverse_neighbors(jp, mp, na)
    want = np.full((len(pos), k_pad), -1, np.int32)
    want[:na, :ref.shape[1]] = ref
    np.testing.assert_array_equal(rev[0].numpy(), want)


# ---------------------------------------------------------------------------
# K5 through reference_eav
# ---------------------------------------------------------------------------

ZBL_CASES = {
    "Ta": (1, ["pair_coeff * * zbl 73 73"]),
    "TaNb": (2, ["pair_coeff 1 1 zbl 73 73", "pair_coeff 1 2 zbl 73 41"]),
}


@pytest.mark.parametrize("case", sorted(ZBL_CASES))
def test_reference_eav_matches_jax(case):
    ntypes, coeffs = ZBL_CASES[case]
    section = SimpleNamespace(lmp_pairdecl=[
        "pair_style hybrid/overlay zero 10.0 zbl 4.0 4.8",
        "pair_coeff * * zero"] + coeffs)
    spec = refpot.parse_reference(section, ntypes)
    jspec = jrefpot.parse_reference(section, ntypes)
    rng = np.random.default_rng(8)
    r_all = []
    for _ in range(3):
        pos, rows = synthetic.liquid(rng, 12, 0.06, 1.5)
        cell = rows.T
        na = len(pos)
        types = rng.integers(0, ntypes, na).astype(np.int32)
        disp, jidx, mask, kc = neighbors.host_neighbors(pos, cell, na, 5.4)
        rev = neighbors.reverse_neighbors(jidx, mask, na)
        re, rf, rv = refpot.reference_eav(
            t(disp)[None], t(jidx)[None], t(mask)[None], t(rev)[None],
            t(types)[None], spec)
        je, jf, jv = jrefpot.reference_eav(
            jnp.asarray(disp), jnp.asarray(jidx), jnp.asarray(mask),
            jnp.asarray(types), na, jspec)
        assert rel(re[0], je) <= RTOL
        assert rel(rf[0], jf) <= RTOL
        assert rel(rv[0], jv) <= RTOL
        r_all.append(np.linalg.norm(disp[mask], axis=-1))
    r = np.concatenate(r_all)
    assert r.min() < 2.0 and ((r > 4.0) & (r < 4.8)).any() and r.max() > 4.8


# ---------------------------------------------------------------------------
# the streamed fit
# ---------------------------------------------------------------------------


def stream_settings(root):
    s = synthetic.ta_settings(root, groups=[])
    s["GROUPS"].update({"Small": "1.0 0.0 100.0 1.0 1e-4",
                        "Super": "1.0 0.0 30.0 2.0 1e-3"})
    return s


def write_stream_configs(root):
    """Three 2-atom and three 16-atom bcc cells, jittered and strained,
    with seeded truths."""
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
def stream(tmp_path_factory):
    root = tmp_path_factory.mktemp("stream")
    data = root / "JSON"
    data.mkdir()
    write_stream_configs(data)
    s = stream_settings(data)
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
    jpacked = [jcalc._pack(d) for d in jfs.data]
    groups = fit.plan_pos_buckets(packed, calc.cutoff, max_programs=1)
    jgroups = jfit.plan_pos_buckets(jpacked, jcalc.cutoff, max_programs=1,
                                    program_cost=6.0)
    assert len(groups) == 1 and len(packed) == 6
    g, jg = groups[0], jgroups[0]
    assert (g["a_pad"], g["k_pad"], g["s_table"]) == \
        (jg["a_pad"], jg["k_pad"], jg["s_table"]) and g["a_pad"] == 16
    batch = fit.pack_batch_pos(g["configs"], g["a_pad"], 6, g["s_table"],
                               np.float64, chunks=2)
    jbatch = jfit.pack_batch_pos(jg["configs"], jg["a_pad"], 6,
                                 jg["s_table"], np.float64, chunks=2)
    for x, y in zip(batch, jbatch):
        np.testing.assert_array_equal(x, y)
    nb = {"cutoff": calc.cutoff, "k_pad": g["k_pad"]}
    args = (calc.params, 1, FLAGS)
    jargs = (jcalc.params, 1, FLAGS, jfit.make_mesh(1))
    out = {"calc": calc, "jcalc": jcalc, "batch": batch, "nb": nb,
           "groups": groups}

    step = fit.build_step_fn(*args, device="cpu", refspec=calc.refspec,
                             neighbors=nb)
    res = fit.build_residual_fn(*args, device="cpu", refspec=calc.refspec,
                                neighbors=nb)
    acc_step, init, finish = fit.build_step_fn(
        *args, device="cpu", refspec=calc.refspec, neighbors=nb,
        accumulate=True)
    jstep = jfit.build_step_fn(*jargs, refspec=jcalc.refspec, neighbors=nb)
    jres = jfit.build_residual_fn(*jargs, refspec=jcalc.refspec,
                                  neighbors=nb)
    jacc_step, jinit, jfinish = jfit.build_step_fn(
        *jargs, refspec=jcalc.refspec, neighbors=nb, accumulate=True)

    out["step"] = step(batch)
    out["jstep"] = jstep(batch)
    acc = acc_step(init(), batch)
    out["acc"] = finish(acc_step(acc, fit.put_batch(batch, "cpu")))
    jacc = jacc_step(jinit(), batch)
    out["jacc"] = jfinish(jacc_step(jacc, batch))
    out["fit"] = fit.fit_refined(step, res, batch)
    out["jfit"] = jfit.fit_refined(jstep, jres, batch)
    x = np.asarray(out["jfit"][0])
    out["res"] = res(x, batch)
    out["jres"] = np.asarray(jres(jnp.asarray(x), batch))
    # the 12-array batch of host neighbor lists, without `neighbors=`
    for pc in g["configs"]:
        pc.disp, pc.jidx, pc.mask, pc.kcount = neighbors.host_neighbors(
            pc.pos, pc.cell, pc.natoms, calc.cutoff)
    lists = fit.pack_batch(g["configs"], g["a_pad"], g["k_pad"], 6,
                           np.float64, chunks=2)
    out["lists"] = fit.build_step_fn(*args, device="cpu",
                                     refspec=calc.refspec)(lists)
    out["jlists"] = jfit.build_step_fn(*jargs,
                                       refspec=jcalc.refspec)(lists)
    ev = fit.build_eval_fn(*args, device="cpu", refspec=calc.refspec,
                           neighbors=nb)
    jev = jfit.build_eval_fn(*jargs, refspec=jcalc.refspec, neighbors=nb)
    out["eval"] = ev(x, batch)
    out["jeval"] = [float(v) for v in jev(jnp.asarray(x), batch)]
    return out


@pytest.mark.parametrize("which", ["step", "acc", "lists"])
def test_step_fn_matches_jax(stream, which):
    """build_step_fn with device neighbor lists; `acc` adds the batch twice
    into one accumulator (once from numpy, once from `put_batch`); `lists`
    takes the host neighbor lists of `pack_batch` instead of positions."""
    AtA, Atb, nrows = stream[which]
    jAtA, jAtb, jn = stream["j" + which]
    assert AtA.shape == (31 * 31,) and Atb.shape == (31,)
    assert rel(AtA, jAtA) <= RTOL
    assert rel(Atb, jAtb) <= RTOL
    assert nrows == float(np.asarray(jn))
    reps = 2 if which == "acc" else 1
    assert nrows == reps * (3 * (1 + 6 + 6) + 3 * (1 + 48 + 6))
    if which == "lists":   # the same system as from the device lists
        assert rel(AtA, stream["step"][0]) <= RTOL
        assert rel(Atb, stream["step"][1]) <= RTOL


def test_residual_fn_matches_jax(stream):
    """A^T W^2 (b - A x) at the JAX fit's coefficients, relative to the
    largest |Atb|."""
    scale = np.abs(stream["jstep"][1]).max()
    assert np.abs(stream["res"] - stream["jres"]).max() / scale <= RTOL


def test_fit_refined_matches_jax(stream):
    x, solver, nrows = stream["fit"]
    jx, _, jn = stream["jfit"]
    assert x.shape == (31,) and np.isfinite(x).all()
    assert rel(x, jx) <= 1e-10
    assert nrows == jn
    assert isinstance(solver, fit.NormalSolver)


def test_eval_fn_matches_jax(stream):
    se, ne, sf, nf = stream["eval"]
    jse, jne, jsf, jnf = stream["jeval"]
    assert (ne, nf) == (jne, jnf) == (6.0, 3 * (3 * 2 + 3 * 16))
    assert abs(se - jse) <= RTOL * jse
    assert abs(sf - jsf) <= RTOL * jsf


def write_inp_configs(root):
    """Three volume-scaled and three strained 8-atom zincblende InP cells
    with seeded truths."""
    rng = np.random.default_rng(23)
    confs = synthetic.inp_configs(7, {"Volume_ZB": 3, "Strain_ZB": 3})
    for group, cells in confs.items():
        (root / group).mkdir()
        for i, (pos, cell, names) in enumerate(cells):
            n = len(pos)
            st = rng.normal(0.0, 2e3, (3, 3))
            (root / group / f"{group}_{i}.json").write_text(
                synthetic.config_json(
                    pos, cell, energy=-3.5 * n + rng.normal(0.0, 0.5),
                    forces=rng.normal(0.0, 0.3, (n, 3)),
                    stress=0.5 * (st + st.T), types=names))


def flag_settings(name, data):
    """Explicit multi-element SNAP (the InP example's chemflag model) or
    quadratic SNAP (the Ta set's), both at twojmax 4."""
    if name == "chemflag":
        write_inp_configs(data)
        s = synthetic.inp_settings(data, groups=["Volume_ZB", "Strain_ZB"])
        s["BISPECTRUM"]["twojmax"] = "4 4"
    else:
        write_stream_configs(data)
        s = stream_settings(data)
        s["BISPECTRUM"].update(twojmax=4, quadraticflag=1)
    return s


@pytest.fixture(scope="module", params=["chemflag", "quadratic"])
def flag_stream(request, tmp_path_factory):
    """The streamed step of each package on six configs of the model, with
    device neighbor lists, in two chunks."""
    root = tmp_path_factory.mktemp(request.param)
    data = root / "JSON"
    data.mkdir()
    s = flag_settings(request.param, data)
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
                               np.float64, chunks=2)
    nb = {"cutoff": calc.cutoff, "k_pad": g["k_pad"]}
    T = calc.numtypes
    step = fit.build_step_fn(calc.params, T, FLAGS, device="cpu",
                             refspec=calc.refspec, neighbors=nb)
    jstep = jfit.build_step_fn(jcalc.params, T, FLAGS, jfit.make_mesh(1),
                               refspec=jcalc.refspec, neighbors=nb)
    return {"width": calc.get_width(), "natoms": [pc.natoms for pc in packed],
            "step": step(batch), "jstep": jstep(batch)}


def test_step_fn_flags_match_jax(flag_stream):
    """build_step_fn under chemflag (two elements, 2 x 112 columns) and
    quadraticflag (14 + 105 columns and one constant) sizes its system as
    the model's width and equals the JAX streamed step."""
    AtA, Atb, nrows = flag_stream["step"]
    jAtA, jAtb, jn = flag_stream["jstep"]
    W = flag_stream["width"]
    assert W in (224, 120)
    assert AtA.shape == (W * W,) and Atb.shape == (W,)
    assert rel(AtA, jAtA) <= RTOL
    assert rel(Atb, jAtb) <= RTOL
    assert nrows == float(np.asarray(jn)) \
        == sum(1 + 3 * n + 6 for n in flag_stream["natoms"])


@pytest.mark.parametrize("mode", ["reference", "residual"])
def test_config_normal_contrib_per_config(stream, mode):
    """One config at a time, on the port's device neighbor lists of the
    streamed batch; the residual mode at seeded coefficients."""
    calc, jcalc, nb = stream["calc"], stream["jcalc"], stream["nb"]
    batch = [x.reshape((-1,) + x.shape[2:]) for x in stream["batch"]]
    coeff = np.random.default_rng(6).normal(size=31) \
        if mode == "residual" else None
    jfn = jax.jit(partial(jfit.config_normal_contrib, params=jcalc.params,
                          numtypes=1, flags=FLAGS, refspec=jcalc.refspec,
                          with_ata=coeff is None,
                          accum_dtype=jnp.float64))
    for c in range(6):
        ph, pl, sh, sl, types, nat, cell, *truths = (x[c] for x in batch)
        disp, jidx, mask = fit.device_neighbors(
            t(ph)[None], t(pl)[None], t(sh)[None], t(sl)[None],
            t(nat)[None], nb["cutoff"], nb["k_pad"])
        port = fit.config_normal_contrib(
            disp, jidx, mask, t(types)[None], t(nat)[None], t(cell)[None],
            *(t(x)[None] for x in truths), params=calc.params, numtypes=1,
            flags=FLAGS, refspec=calc.refspec,
            coeff=None if coeff is None else t(coeff),
            with_ata=coeff is None)
        ref = jfn(disp[0].numpy(), jidx[0].numpy(), mask[0].numpy(), types,
                  nat, cell, *truths,
                  coeff=None if coeff is None else jnp.asarray(coeff))
        if coeff is None:
            assert rel(port[0], ref[0]) <= RTOL
        assert rel(port[1], ref[1]) <= RTOL
        assert float(port[2]) == float(ref[2])


def test_truncated_reverse_table_is_refused():
    """Four slots point at atom 0 of a list two slots wide: two entries
    fall past the table and the streamed functions refuse it."""
    jidx = torch.zeros((1, 3, 2), dtype=torch.int32)
    mask = torch.zeros((1, 3, 2), dtype=torch.bool)
    mask[0, 1:] = True
    rev, dropped = sk.reverse_table(jidx, mask)
    assert rev[0, 0].tolist() == [2, 3] and int(dropped[0]) == 2
    with pytest.raises(RuntimeError, match="past the table width"):
        fit._check_dropped(dropped)


@pytest.mark.parametrize("packer", ["pack_batch_pos", "pack_batch"])
def test_float32_batch_is_refused(stream, packer):
    """The packers default to float64; a float32 batch (the JAX package's
    default) is refused, not widened from its rounded values."""
    calc, nb = stream["calc"], stream["nb"]
    cfgs = stream["groups"][0]["configs"]
    a_pad, k_pad, s_table = (stream["groups"][0][k]
                             for k in ("a_pad", "k_pad", "s_table"))

    def pack(*dtype):
        if packer == "pack_batch_pos":
            return fit.pack_batch_pos(cfgs, a_pad, 6, s_table, *dtype)
        return fit.pack_batch(cfgs, a_pad, k_pad, 6, *dtype)

    assert all(x.dtype == np.float64 for x in pack() if x.dtype.kind == "f")
    f32 = pack(np.float32)
    with pytest.raises(TypeError, match="float64"):
        fit.put_batch(f32, "cpu")
    step = fit.build_step_fn(calc.params, 1, FLAGS, device="cpu",
                             refspec=calc.refspec,
                             neighbors=nb if packer == "pack_batch_pos"
                             else None)
    with pytest.raises(TypeError, match="float64"):
        step(f32)


def test_ace_and_const_mode_raise():
    """A descriptor kernel other than `ace_kernel(plan)`, the ACE constant
    columns without it, and the SNAP constant layout with it are refused
    (ACE itself runs: tests/test_torch_ace.py)."""
    with pytest.raises(TypeError, match="ace_kernel"):
        fit.build_step_fn(None, 1, FLAGS, device="cpu",
                          kernel=lambda *a: None)
    with pytest.raises(ValueError, match="ace_kernel"):
        fit.build_residual_fn(None, 1, FLAGS, device="cpu",
                              const_mode=("ace", 1))
    plan = SimpleNamespace(labels=[None] * 5)
    with pytest.raises(ValueError, match="does not go with an ACE kernel"):
        fit.build_step_fn(None, 2, FLAGS, device="cpu",
                          kernel=fit.ace_kernel(plan), const_mode="snap")


# ---------------------------------------------------------------------------
# device solvers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["TpuSVD", "TfSVD"])
def test_device_solvers_match_jax(name):
    rng = np.random.default_rng(12)
    a = rng.normal(size=(240, 31)) * rng.uniform(0.1, 10.0, 31)
    b = a @ rng.normal(size=31) + rng.normal(0.0, 0.1, 240)
    w = rng.uniform(0.5, 2.0, 240)
    fs_dict = {"Testing": list(rng.uniform(size=240) < 0.2)}
    port_cls, jax_cls = {"TpuSVD": (TpuSVD, JaxTpuSVD),
                         "TfSVD": (TfSVD, JaxTfSVD)}[name]
    port = port_cls(name, None, device="cpu").perform_fit(a, b, w, fs_dict)
    ref = jax_cls(name, None).perform_fit(a, b, w, fs_dict)
    assert rel(port, ref) <= 1e-10
