"""The port's native (C++) host neighbor builder against the JAX package's
and against the port's numpy version (CPU, float64).

`fitsnap_tpu_torch/native` builds its own copy of `neighbors.cpp` with g++
into the checkout's `build/`; `ops/neighbors.host_neighbors` and
`count_neighbors` run it, and `host_neighbors_plain` /
`count_neighbors_plain` are the numpy versions.  Inputs are made from
seeds: triclinic cells of 1-40 atoms, a 2-atom cell small enough to need
many periodic images, and padded a_pad / k_pad.  Checks:

- mask and jidx equal, slot for slot, to `fitsnap_tpu.native
  .host_neighbors_native` and to the numpy version; disp within 1e-12 A
  (-march=native may contract the shift sums into FMAs); the counts equal;
- count mode (`count_neighbors`) equal to both;
- a k_pad below the largest count raises ValueError naming the count
  needed; a source that does not compile raises with g++'s messages;
- the library is built from the port's source into
  `build/fitsnap_tpu_torch/native/<digest>/`, the digest changing with
  the compiler and CPU it hashes;
- `FitSnap`'s A, b and w on a synthetic Ta set (the ten groups, a few
  configs each) within 1e-12 relative of the same fit with the numpy lists.
"""

import os
from pathlib import Path

import numpy as np
import pytest

from fitsnap_tpu.native import host_neighbors_native as jax_native
from fitsnap_tpu_torch import FitSnap
from fitsnap_tpu_torch import native
from fitsnap_tpu_torch.calculators import snap as tsnap
from fitsnap_tpu_torch.ops import neighbors
from fitsnap_tpu_torch.tools import synthetic

ROOT = Path(__file__).resolve().parent.parent
CUTOFF = 4.8


def triclinic(rng, na, scale=1.0):
    cell = np.triu(rng.uniform(4, 9, (3, 3))) * scale
    cell[0, 1:] *= 0.3
    cell[1, 2] *= 0.3
    return rng.uniform(0, 1, (na, 3)) @ cell.T, cell


def cases():
    rng = np.random.default_rng(5)
    out = [triclinic(rng, na) for na in (1, 3, 8, 17, 40)]
    out.append(triclinic(rng, 2, scale=0.3))     # many images
    return out


def same_lists(got, want, disp_tol=1e-12):
    disp, jidx, mask, kmax = got
    assert disp.shape == want[0].shape
    np.testing.assert_array_equal(mask, want[2])
    np.testing.assert_array_equal(jidx, want[1])
    assert np.abs(disp - want[0]).max(initial=0.0) <= disp_tol
    assert kmax == want[3]


@pytest.mark.parametrize("index", range(len(cases())))
@pytest.mark.parametrize("pad", [(None, None), (48, None), (48, 400)])
def test_lists_equal_jax_and_plain(index, pad):
    pos, cell = cases()[index]
    na = len(pos)
    got = neighbors.host_neighbors(pos, cell, na, CUTOFF, *pad)
    assert got[2].dtype == bool and got[1].dtype == np.int32
    same_lists(got, jax_native(pos, cell, na, CUTOFF, *pad))
    same_lists(got, neighbors.host_neighbors_plain(pos, cell, na, CUTOFF,
                                                   *pad))
    if index == len(cases()) - 1:
        assert got[3] > 100      # the small cell meets many images


@pytest.mark.parametrize("index", range(len(cases())))
def test_count_equals_jax_and_plain(index):
    pos, cell = cases()[index]
    na = len(pos)
    count = neighbors.count_neighbors(pos, cell, na, CUTOFF)
    assert count == neighbors.count_neighbors_plain(pos, cell, na, CUTOFF)
    assert count == jax_native(pos, cell, na, CUTOFF)[3]


def test_k_pad_too_small_raises():
    pos, cell = cases()[3]
    need = neighbors.count_neighbors(pos, cell, len(pos), CUTOFF)
    with pytest.raises(ValueError, match=f"need {need}"):
        neighbors.host_neighbors(pos, cell, len(pos), CUTOFF, a_pad=20,
                                 k_pad=need - 1)


def test_library_is_the_ports_own_build():
    lib = native.get_lib()
    where = native.build_dir()
    assert native.SOURCE == ROOT / "fitsnap_tpu_torch/native/neighbors.cpp"
    assert where.parent == ROOT / "build/fitsnap_tpu_torch/native"
    assert (where / "fsnative.so").exists()
    assert Path(lib._name) == where / "fsnative.so"


def test_digest_follows_compiler_and_cpu(monkeypatch):
    base = native.build_dir()
    monkeypatch.setattr(native, "_cpu_model", lambda: "another cpu")
    assert native.build_dir() != base


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "neighbors.cpp"
    bad.write_text("int fs_neighbors( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native._build()
    assert not list((tmp_path / "build").rglob("*.so"))


@pytest.fixture(scope="module")
def ta_rows(tmp_path_factory):
    root = tmp_path_factory.mktemp("native_fit")
    synthetic.write_dataset(root / "JSON", synthetic.ta_configs(
        3, {g: 2 for g in synthetic.TA_GROUPS}))
    s = synthetic.ta_settings(root / "JSON")
    s["BISPECTRUM"]["twojmax"] = 4
    out = {}
    cwd = os.getcwd()
    os.chdir(root)
    try:
        for name in ("native", "plain"):
            with pytest.MonkeyPatch.context() as mp:
                if name == "plain":
                    mp.setattr(tsnap, "host_neighbors",
                               neighbors.host_neighbors_plain)
                fs = FitSnap(s, arglist=["--overwrite"], device="cpu")
                fs.scrape_configs()
                fs.process_configs()
                out[name] = (fs.a, fs.b, fs.w)
    finally:
        os.chdir(cwd)
    return out


@pytest.mark.parametrize("part", [0, 1, 2], ids=["a", "b", "w"])
def test_fit_rows_equal_plain_lists(ta_rows, part):
    got, want = ta_rows["native"][part], ta_rows["plain"][part]
    assert got.shape == want.shape and got.shape[0] > 100
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
