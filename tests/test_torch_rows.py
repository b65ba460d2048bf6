"""fitsnap_tpu_torch SnapCalculator.rows against the JAX rows function
(CPU, float64).

A few small periodic cells (bcc and fcc, 2-8 atoms, seeded jitter, cells
so small that an atom meets its own periodic images) are scraped by both
packages from the same JSON files.  The port packs them into one batch and
its rows function (kernels K1-K4 through their plain versions on the CPU)
is compared with `fitsnap_tpu.calculators.snap.SnapCalculator._rows_fn` on
the same arrays: e_cols, force_rows, virial_rows and the ZBL reference
energy, forces and virial.  Cases: the Ta model (twojmax 6, one type) and a
two-type Ta/Nb model (twojmax 4, bzeroflag 1) that exercises the type
blocking of the row scatter.  Tolerance: 1e-12 relative to the largest
magnitude of each array (the packages sum in different orders).

The host neighbor lists equal the JAX package's slot for slot, and the
reverse neighbor table that K4 reads is checked against a brute-force
build.
"""

import numpy as np
import pytest
import torch

from fitsnap_tpu.fitsnap import FitSnap as JaxFitSnap
from fitsnap_tpu.ops import neighbors as jneighbors
from fitsnap_tpu_torch import FitSnap
from fitsnap_tpu_torch.kernels import snap_kernels as sk
from fitsnap_tpu_torch.ops import neighbors
from fitsnap_tpu_torch.tools import synthetic

RTOL = 1e-12
KEYS = ("e_cols", "force_rows", "virial_rows", "ref_e", "ref_f", "ref_v")

CASES = {
    "Ta": dict(types=("Ta",), twojmax=6, bzeroflag=0, radelem="0.5",
               wj="1.0", zbl=("* * zbl 73 73",)),
    "TaNb": dict(types=("Ta", "Nb"), twojmax=4, bzeroflag=1,
                 radelem="0.5 0.47", wj="1.0 0.8",
                 zbl=("1 1 zbl 73 73", "1 2 zbl 73 41", "2 2 zbl 41 41")),
}


def cells(seed):
    """(positions, cell rows) of small cells, all with 8 or fewer atoms and
    17-32 neighbors inside 4.8 A, so they share one shape bucket."""
    rng = np.random.default_rng(seed)
    out = []
    for a, reps, jitter in ((3.3, (1, 1, 1), 0.05), (3.0, (1, 1, 1), 0.08),
                            (3.3, (2, 2, 1), 0.1)):
        pos, cell = synthetic.supercell(synthetic.BCC, a, reps)
        out.append((pos + rng.normal(0.0, jitter, pos.shape), cell))
    pos, cell = synthetic.supercell(synthetic.FCC, 4.22, (1, 1, 1))
    cell = synthetic.strained(cell, rng, 0.03)
    out.append((pos @ np.linalg.solve(np.diag([4.22] * 3), cell)
                + rng.normal(0.0, 0.05, pos.shape), cell))
    return out


def settings(spec, root):
    return {
        "BISPECTRUM": {
            "numTypes": len(spec["types"]),
            "twojmax": " ".join([str(spec["twojmax"])] * len(spec["types"])),
            "rcutfac": 4.67637, "rfac0": 0.99363, "rmin0": 0.0,
            "wj": spec["wj"], "radelem": spec["radelem"],
            "type": " ".join(spec["types"]), "wselfallflag": 0,
            "chemflag": 0, "bzeroflag": spec["bzeroflag"],
            "quadraticflag": 0},
        "CALCULATOR": {"calculator": "LAMMPSSNAP", "energy": 1, "force": 1,
                       "stress": 1},
        "ESHIFT": {t: 0.0 for t in spec["types"]},
        "SOLVER": {"solver": "SVD"},
        "SCRAPER": {"scraper": "JSON"},
        "PATH": {"dataPath": str(root)},
        "OUTFILE": {"metrics": "rows_metrics.md", "potential": "rows_pot"},
        "REFERENCE": dict({
            "units": "metal", "atom_style": "atomic",
            "pair_style": "hybrid/overlay zero 10.0 zbl 4.0 4.8",
            "pair_coeff1": "* * zero"},
            **{f"pair_coeff{i + 2}": z for i, z in enumerate(spec["zbl"])}),
        "GROUPS": {
            "group_sections": "name training_size testing_size eweight "
                              "fweight vweight",
            "group_types": "str float float float float float",
            "smartweights": 0, "random_sampling": 0,
            "Cells": "1.0 0.0 1.0 1.0 1.0"},
        "EXTRAS": {}, "MEMORY": {},
    }


@pytest.fixture(scope="module", params=sorted(CASES))
def batch(request, tmp_path_factory):
    spec = CASES[request.param]
    root = tmp_path_factory.mktemp(f"rows_{request.param}")
    (root / "Cells").mkdir()
    rng = np.random.default_rng(5)
    for i, (pos, cell) in enumerate(cells(3)):
        types = rng.choice(spec["types"], len(pos))
        (root / "Cells" / f"cell_{i}.json").write_text(
            synthetic.config_json(pos, cell, types=types))
    s = settings(spec, root)
    fs = FitSnap(s, arglist=["--overwrite"], device="cpu")
    calc = fs.calculator
    packed, buckets = calc.host_preprocess(fs.scrape_configs())
    assert len(buckets) == 1
    ids, args = next(iter(calc.batches(packed, buckets)))
    port = calc.rows(*args)

    jfs = JaxFitSnap(s, arglist=["--overwrite"])
    disp, jidx, mask, rev, types, nat, cell = (x.numpy() for x in args)
    C, A, K = mask.shape
    fn = jfs.calculator._rows_fn(A, K, np.dtype(np.float64))
    ref = fn(disp, jidx, mask, types, nat.astype(np.int32), cell,
             np.zeros((C, A, 3)), np.zeros((C, A)))
    return dict(port=port, ref={k: np.asarray(v) for k, v in ref.items()},
                packed=[packed[i] for i in ids], args=args)


def close(port, ref, rtol=RTOL):
    port = port.detach().cpu().numpy()
    assert port.shape == ref.shape
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)
    assert err <= rtol, f"relative error {err:.3e}"


@pytest.mark.parametrize("key", KEYS)
def test_rows_match_jax(batch, key):
    close(batch["port"][key], batch["ref"][key])


def test_reference_potential_is_active(batch):
    """The cells reach into ZBL's range, so the reference rows are real."""
    assert np.abs(batch["ref"]["ref_e"]).min() > 1e-6
    assert np.abs(batch["ref"]["ref_f"]).max() > 1e-6


@pytest.mark.parametrize("index", range(4))
def test_host_neighbors_match_jax(index):
    """disp, jidx, mask and the count, slot for slot, padded or not."""
    pos, cell = cells(3)[index]
    cols = cell.T
    for pad in ((None, None), (10, 40)):
        port = neighbors.host_neighbors(pos, cols, len(pos), 4.8, *pad)
        ref = jneighbors.host_neighbors(pos, cols, len(pos), 4.8, *pad)
        for x, y in zip(port[:3], ref[:3]):
            np.testing.assert_array_equal(x, y)
        assert port[3] == ref[3] == neighbors.count_neighbors(
            pos, cols, len(pos), 4.8)


def test_reverse_neighbors_brute_force(batch):
    """Each row of the reverse table lists, in increasing order, every
    slot (i, k) whose neighbor is that atom, self images repeated."""
    saw_self_image = False
    for pc in batch["packed"]:
        n_k = pc.kcount
        for n in range(pc.natoms):
            want = [i * n_k + k for i in range(pc.natoms)
                    for k in range(n_k)
                    if pc.mask[i, k] and pc.jidx[i, k] == n]
            row = pc.rev[n]
            assert row[:len(want)].tolist() == want
            assert (row[len(want):] == -1).all()
            saw_self_image |= any(s // n_k == n for s in want)
    assert saw_self_image


def test_row_scatter_plain_matches_brute_force(batch):
    """K4's plain version against an explicit loop over the pairs."""
    disp, jidx, mask, rev, types, _, _ = batch["args"]
    C, A, K = mask.shape
    T, X = 2, 3
    rng = np.random.default_rng(9)
    g = rng.normal(size=(C, A, X, K, 3)) * mask.numpy()[:, :, None, :, None]
    ty = rng.integers(0, T, (C, A)).astype(np.int32)
    force, virial = sk.pair_scatter_rows(
        torch.from_numpy(g), disp, mask, rev, torch.from_numpy(ty), T)
    f = np.zeros((C, A, 3, T, X))
    v = np.zeros((C, 3, 3, T, X))
    d, m, ji = disp.numpy(), mask.numpy(), jidx.numpy()
    for c, i, k in zip(*np.nonzero(m)):
        t = ty[c, i]
        f[c, ji[c, i, k], :, t] -= g[c, i, :, k].T
        f[c, i, :, t] += g[c, i, :, k].T
        v[c, :, :, t] -= np.einsum("a,xb->abx", d[c, i, k], g[c, i, :, k])
    v6 = v[:, [0, 1, 2, 1, 0, 0], [0, 1, 2, 2, 2, 1]]
    np.testing.assert_allclose(force.numpy(), f, rtol=0, atol=1e-12)
    np.testing.assert_allclose(virial.numpy(), v6, rtol=0, atol=1e-12)


def test_row_scatter_gather_only_plain_matches_brute_force(batch):
    """K4's plain version with `gather_only`: minus the gathers into each
    atom alone, no own row sums, no virial."""
    disp, jidx, mask, rev, types, _, _ = batch["args"]
    C, A, K = mask.shape
    T, X = 2, 3
    rng = np.random.default_rng(10)
    g = rng.normal(size=(C, A, X, K, 3)) * mask.numpy()[:, :, None, :, None]
    ty = rng.integers(0, T, (C, A)).astype(np.int32)
    force, virial = sk.pair_scatter_rows(
        torch.from_numpy(g), disp, mask, rev, torch.from_numpy(ty), T,
        gather_only=True)
    f = np.zeros((C, A, 3, T, X))
    m, ji = mask.numpy(), jidx.numpy()
    for c, i, k in zip(*np.nonzero(m)):
        f[c, ji[c, i, k], :, ty[c, i]] -= g[c, i, :, k].T
    assert virial is None
    np.testing.assert_allclose(force.numpy(), f, rtol=0, atol=1e-12)
