#!/usr/bin/env python3
"""Quick proof that the PyTorch/CUDA port (fitsnap_tpu_torch) runs on a GPU.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout on a machine with an NVIDIA H100.  Phases:

1. card: the `nvidia-smi` name and power limit; build of the CUDA kernels
   from fitsnap_tpu_torch/kernels/csrc (nvcc, sm_90a) and its time;
2. data: a synthetic Ta-shaped training set (about 360 FitSNAP JSON configs
   from --seed, in a temporary directory) and an input file with the
   Ta_Linear_JCP2014 example's sections; the truths are A_plain @ beta_true
   plus the ZBL reference, with A_plain computed by the plain path on the
   card and beta_true drawn from the seed;
3. kernels: each of K1-K4 against its plain PyTorch version on the card at
   the main path's Ta shapes (one chunk of 8 compressed 128-atom bcc cells,
   64 neighbor slots, twojmax 6, float64), failing above 1e-11 relative
   error; kernel, plain and library-call times with CUDA events, and the
   least time the card could take (bytes over 3.35 TB/s, FP64 flops over
   67 TFLOP/s, the larger);
4. main path: launch counts set to 0, then FitSnap(device="cuda") ->
   scrape_configs -> process_configs -> perform_fit -> write_output, the
   counts read just after.  It fails unless every kernel launched, the A
   matrix equals A_plain to 1e-10 relative (per column), and the fit
   recovers beta_true within 100 * cond(weighted A) * 2.2e-16.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device, or run where the
package is missing, it exits non-zero and prints no result.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 bandwidth (NVIDIA data sheet)
FP64_FLOPS = 67e12          # H100 SXM FP64 tensor-core peak (NVIDIA data sheet)
KERNEL_RTOL = 1e-11         # kernel vs plain, relative to the largest |value|
A_RTOL = 1e-10              # main-path A vs plain A, per column
RESID_RTOL = 1e-10          # weighted fit residual, relative to |w b|
EPS64 = 2.220446049250313e-16

SOURCES = {
    "pair_u_duals": ("fitsnap_tpu_torch/kernels/csrc/pair_u_duals.cu",
                     "fitsnap_tpu/ops/snap.py:667"),
    "zlist": ("fitsnap_tpu_torch/kernels/csrc/zlist.cu",
              "fitsnap_tpu/ops/snap.py:1061"),
    "dbdd": ("fitsnap_tpu_torch/kernels/csrc/dbdd.cu",
             "fitsnap_tpu/ops/snap.py:823"),
    "pair_scatter_rows": ("fitsnap_tpu_torch/kernels/csrc/pair_scatter.cu",
                          "fitsnap_tpu/calculators/snap.py:326"),
}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def timed(fn, reps):
    """Mean milliseconds of fn() on the card (CUDA events, one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP64_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rel_err(out, ref):
    """(max abs error, max abs error / max |ref|) over paired tensors."""
    worst_abs, worst_rel = 0.0, 0.0
    for o, r in zip(out, ref):
        a = (o - r).abs().max().item()
        worst_abs = max(worst_abs, a)
        worst_rel = max(worst_rel, a / max(r.abs().max().item(), 1e-300))
    return worst_abs, worst_rel


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def make_dataset(tmp, seed, device):
    """Write the synthetic set with truths A_plain @ beta_true + ZBL.

    Returns (input file, the FitSnap that computed A_plain, its scraped
    data, A_plain, beta_true, seconds of the plain path on the card)."""
    import torch
    from fitsnap_tpu_torch import FitSnap
    from fitsnap_tpu_torch.tools import synthetic

    root = Path(tmp) / "JSON"
    files = synthetic.write_dataset(root, synthetic.ta_configs(seed))
    ini = Path(tmp) / "Ta-example.in"
    synthetic.write_ini(ini, synthetic.ta_settings(root))

    fs0 = FitSnap(str(ini), arglist=["--overwrite"], device=device)
    data = fs0.scrape_configs()
    t0 = time.time()
    a, b0, _, _ = fs0.calculator.process_configs(data, plain=True)
    torch.cuda.synchronize()
    t_plain = time.time() - t0
    rng = np.random.default_rng(seed + 1)
    beta = rng.normal(size=a.shape[1])
    natoms = [d["NumAtoms"] for d in data]
    for d, (e, f, s) in zip(data, synthetic.truths_from_rows(
            a, b0, beta, natoms)):
        pos, cell = files[(d["Group"], d["File"])]
        (root / d["Group"] / d["File"]).write_text(
            synthetic.config_json(pos, cell, e, f, s))
    return ini, fs0, data, a, beta, t_plain


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_checks(calc, data):
    """K1-K4 vs plain on the first Compressed_BCC chunk (8 x 128 x 64)."""
    import torch
    from fitsnap_tpu_torch.kernels import snap_kernels as sk
    from fitsnap_tpu_torch.ops import snap as ops
    from fitsnap_tpu_torch.ops.cg import build_snap_plan

    chunk = [d for d in data if d["Group"] == "Compressed_BCC"][:8]
    packed, buckets = calc.host_preprocess(chunk)
    _, args = next(iter(calc.batches(packed, buckets)))
    disp, jidx, mask, rev, types, natoms, cell = args
    p = calc.params
    C, A, K = mask.shape
    N, U, W, T = C * A, p.u_len, p.ntriples, calc.numtypes
    jelem, smask = calc.pair_masks(disp, jidx, mask, types)
    k1_in = (disp.reshape(N, K, 3), jelem.reshape(N, K),
             smask.reshape(N, K), types.reshape(N))
    npairs = int(smask.sum().item())
    print(f"kernel inputs: C={C} A={A} K={K} pairs={npairs} twojmax="
          f"{p.twojmax} float64", flush=True)
    rows = []

    def record(name, out, ref, ms, plain_ms, nbytes, flops, library_ms):
        err_abs, err_rel = rel_err(out, ref)
        b_ms, b_by = bound_ms(nbytes, flops)
        print(f"{name}: max_abs_err={err_abs:.3e} max_rel_err={err_rel:.3e}"
              f" ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f}"
              f" ({b_by}) library_ms={library_ms}", flush=True)
        if not err_rel <= KERNEL_RTOL:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version ({err_rel:.3e} > {KERNEL_RTOL})")
        src, replaces = SOURCES[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "max_abs_err": err_abs,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": library_ms})

    # K1
    out = sk.pair_u_duals(*k1_in, p)
    ref = sk.pair_u_duals_plain(*k1_in, p)
    n_mono = p.mono_parent.shape[0]
    nnz_l = p.l_val.shape[0]
    k1_flops = npairs * ((n_mono - 1) * 10 + nnz_l * 8 + 2 * U * 11 + 600)
    k1_bytes = N * K * (3 * 8 + 4 + 1) + N * 4 + 4 * N * K * 2 * U * 8 \
        + N * 2 * U * 8
    record("pair_u_duals", out, ref,
           timed(lambda: sk.pair_u_duals(*k1_in, p), 10),
           timed(lambda: sk.pair_u_duals_plain(*k1_in, p), 3),
           k1_bytes, k1_flops, None)
    wu, J, ut = ref
    del out

    # K2, with torch.bmm over the TPU path's dense term GEMMs as library call
    out = sk.zlist(ut, p)
    ref = sk.zlist_plain(ut, p)
    nterms = p.z_c.shape[0]
    groups = build_snap_plan(p.twojmax, bzeroflag=p.bzeroflag
                             ).z_dense["groups"]
    dense = []
    for g in groups:
        gi1 = torch.as_tensor(g["gi1"], device=ut.device).long()
        gi2 = torch.as_tensor(g["gi2"], device=ut.device).long()
        a_r, a_i = ut[:, :U][:, gi1], ut[:, U:][:, gi1]
        b_r, b_i = ut[:, :U][:, gi2], ut[:, U:][:, gi2]
        dense.append(((a_r * b_r - a_i * b_i).transpose(0, 1).contiguous(),
                      (a_r * b_i + a_i * b_r).transpose(0, 1).contiguous(),
                      torch.as_tensor(g["M"], device=ut.device)))

    def bmm_groups():
        return [(torch.bmm(pr, M), torch.bmm(pi, M)) for pr, pi, M in dense]

    record("zlist", out, ref, timed(lambda: sk.zlist(ut, p), 20),
           timed(lambda: sk.zlist_plain(ut, p), 5),
           N * 2 * U * 8 + 2 * N * p.nz * 8, N * nterms * 10,
           timed(bmm_groups, 20))
    z_r, z_i = ref
    del out, dense

    # K3, with torch.einsum of the pair contraction as library call
    out = sk.dbdd(ut, z_r, z_i, J, p)
    ref = sk.dbdd_plain(ut, z_r, z_i, J, p)
    dbdu = ops._dbdu_ylist(ut, p, (z_r, z_i))
    k3_flops = N * W * U * 16 + npairs * W * 3 * 2 * U * 2
    k3_bytes = (N * 2 * U + 2 * N * p.nz + 3 * N * K * 2 * U + N * W
                + N * W * K * 3) * 8
    record("dbdd", out, ref, timed(lambda: sk.dbdd(ut, z_r, z_i, J, p), 10),
           timed(lambda: sk.dbdd_plain(ut, z_r, z_i, J, p), 3),
           k3_bytes, k3_flops,
           timed(lambda: torch.einsum("awu,caku->awkc", dbdu, J), 10))
    B, G = ref
    del out, dbdu, wu, J

    # K4, with index_add_ of the neighbor scatter as library call
    real = (torch.arange(A, device=disp.device)[None, :]
            < natoms[:, None]).to(disp.dtype)
    G = (G.reshape(C, A, W, K, 3) * real[..., None, None, None]).contiguous()
    k4_args = (G, disp, smask, rev, types, T)
    out = sk.pair_scatter_rows(*k4_args)
    ref = sk.pair_scatter_rows_plain(*k4_args)
    dest = (torch.arange(C, device=disp.device)[:, None, None] * A
            + jidx.long())[smask]
    g_rows = G.permute(0, 1, 3, 2, 4)[smask].reshape(-1, W * 3)
    scat = torch.zeros((N, W * 3), dtype=G.dtype, device=G.device)
    k4_bytes = (G.numel() + disp.numel() + C * A * 3 * T * W
                + C * 6 * T * W) * 8 + smask.numel() + rev.numel() * 4 \
        + types.numel() * 4
    record("pair_scatter_rows", out, ref,
           timed(lambda: sk.pair_scatter_rows(*k4_args), 20),
           timed(lambda: sk.pair_scatter_rows_plain(*k4_args), 5),
           k4_bytes, npairs * W * (3 * 2 + 6 * 2),
           timed(lambda: scat.index_add_(0, dest, g_rows), 20))
    torch.cuda.synchronize()
    return rows


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


def main_path(ini, a_plain, beta, device):
    """Drive FitSnap on the card; returns (launch counts, timings, checks)."""
    import torch
    from fitsnap_tpu_torch import FitSnap
    from fitsnap_tpu_torch.kernels import snap_kernels as sk

    sk.reset_launches()
    t0 = time.time()
    fs = FitSnap(str(ini), arglist=["--overwrite"], device=device)
    fs.scrape_configs()
    fs.process_configs()
    fs.perform_fit()
    fs.write_output()
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = sk.launches()

    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    if fs.a.shape != a_plain.shape:
        raise AssertionError(f"A shape {fs.a.shape} != {a_plain.shape}")
    col_scale = np.maximum(np.abs(a_plain).max(0), 1e-300)
    a_err = (np.abs(fs.a - a_plain).max(0) / col_scale).max()
    if not (np.isfinite(fs.a).all() and a_err <= A_RTOL):
        raise AssertionError(f"A differs from the plain path: {a_err:.3e}")
    train = ~np.asarray(fs.fs_dict["Testing"])
    aw = fs.w[train][:, None] * fs.a[train]
    bw = fs.w[train] * fs.b[train]
    sv = np.linalg.svd(aw, compute_uv=False)
    cond = sv[0] / sv[-1]
    beta_tol = 100 * cond * EPS64
    beta_err = np.abs(fs.fit - beta).max() / np.abs(beta).max()
    if not (np.isfinite(fs.fit).all() and beta_err <= beta_tol):
        raise AssertionError(f"fit misses beta_true: {beta_err:.3e} > "
                             f"{beta_tol:.3e} (cond {cond:.3e})")
    # the truths are A @ beta_true, so the weighted residual is rounding
    resid = np.linalg.norm(aw @ fs.fit - bw) / np.linalg.norm(bw)
    if not resid <= RESID_RTOL:
        raise AssertionError(f"weighted residual {resid:.3e} > {RESID_RTOL}")
    pot = fs.config.sections["OUTFILE"].potential_name
    coeff_lines = Path(pot + ".snapcoeff").read_text().splitlines()
    n_coeff = int(coeff_lines[2].split()[1])
    if n_coeff != a_plain.shape[1]:
        raise AssertionError(f".snapcoeff lists {n_coeff} coefficients")
    # rsq is -inf by definition for a row group with constant truths, so
    # only ncount, mae and rmse must be finite
    errs = fs.solver.errors
    if not (len(errs) and np.isfinite(errs.values[:, :3]).all()):
        raise AssertionError("empty or non-finite error table")
    checks = {"rows": int(fs.a.shape[0]), "width": int(fs.a.shape[1]),
              "configs": len(set(fs.fs_dict["Configs"])),
              "a_rel_err": float(a_err), "cond_weighted_a": float(cond),
              "beta_rel_err": float(beta_err), "beta_tol": float(beta_tol),
              "resid_rel": float(resid), "wall_s": wall}
    return counts, dict(fs.timings), checks


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    try:
        from fitsnap_tpu_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: fitsnap_tpu_torch is missing beside "
              f"chip_smoke.py ({e})", file=sys.stderr)
        return 3

    print(card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.time()
    out = build.build_all()
    print(f"kernel build: {time.time() - t0:.2f} s into {out}", flush=True)
    for name in build.SOURCES:
        log = (out / f"{name}.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}", flush=True)

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            t0 = time.time()
            ini, fs0, data, a_plain, beta, t_plain = make_dataset(
                tmp, args.seed, "cuda")
            print(f"data: {len(data)} configs, A {a_plain.shape}, plain "
                  f"path on the card {t_plain:.2f} s, set-up "
                  f"{time.time() - t0:.2f} s", flush=True)
            kernels = kernel_checks(fs0.calculator, data)
            del fs0
            torch.cuda.empty_cache()
            counts, timings, checks = main_path(ini, a_plain, beta, "cuda")
        finally:
            os.chdir(cwd)
    print("main path stage timings: " + " ".join(
        f"{k}={v:.3f}s" for k, v in timings.items()), flush=True)
    print("main path checks: " + json.dumps(checks), flush=True)
    for row in kernels:
        row["launches"] = counts[row["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
