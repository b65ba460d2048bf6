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
3. kernels: each of K1-K5, K7, K8 and K8r against its plain PyTorch
   version on the card at the main paths' Ta shapes (one chunk of 8
   compressed 128-atom bcc cells, 64 neighbor slots, twojmax 6, float64;
   K8 and K8r on that chunk's positions batch), failing above 1e-11
   relative error (K8's mask and jidx and K8r's table must be equal); kernel,
   plain and library-call times with CUDA events, the kernel's device time
   from a torch.profiler trace (events between launches also count the
   host's launch overhead, which exceeds the small kernels' run time), and
   the least time the card could take (bytes over 3.35 TB/s, float64
   operations over 67 T/s, the larger; K8r's by its bytes alone);
4. FitSnap path: launch counts set to 0, then FitSnap(device="cuda") ->
   scrape_configs -> process_configs -> perform_fit -> write_output, the
   counts read just after.  It fails unless K1-K5 launched, the A matrix
   equals A_plain to 1e-10 relative (per column), and the fit recovers
   beta_true within 100 * cond(weighted A) * 2.2e-16;
5. streamed path (fitsnap_tpu_torch.parallel.fit): launch counts set to 0,
   then pack (plan_shift_groups, pack_batch_pos), the accumulating step with
   device neighbor lists over every group (a first pass and three steady
   passes), NormalSolver, fit_refined (2 refinement passes) and
   build_eval_fn, the counts read just after.  It fails unless all eight
   kernels launched, nrows equals A_plain's rows, AtA and Atb equal
   (w A_plain)^T (w A_plain) and (w A_plain)^T (w b) to 1e-10 of their
   largest magnitude, the direct solve is within 100 cond^2 eps and the
   refined one within 100 cond eps of beta_true, and the MAE sums equal the
   host's from A_plain and b to 1e-10 relative.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device, or run where the
package is missing, it exits non-zero and prints no result.
"""

import argparse
import json
import os
import re
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
NORMAL_RTOL = 1e-10         # streamed AtA / Atb vs the host's from A_plain
MAE_RTOL = 1e-10            # streamed MAE sums vs the host's
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
    "zbl_pair_grad": ("fitsnap_tpu_torch/kernels/csrc/zbl_pair.cu",
                      "fitsnap_tpu/ops/refpot.py:239"),
    "normal_contrib": ("fitsnap_tpu_torch/kernels/csrc/normal_contrib.cu",
                       "fitsnap_tpu/parallel/fit.py:235"),
    "device_neighbors": ("fitsnap_tpu_torch/kernels/csrc/device_neighbors.cu",
                         "fitsnap_tpu/parallel/fit.py:69"),
    "reverse_table": ("fitsnap_tpu_torch/kernels/csrc/device_neighbors.cu",
                      "fitsnap_tpu/parallel/fit.py:276"),
}
FITSNAP_KERNELS = ("pair_u_duals", "zlist", "dbdd", "pair_scatter_rows",
                   "zbl_pair_grad")
FLAGS = {"energy": True, "force": True, "stress": True}


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


def profile_kernels(fn):
    """Device time of one fn() call by kernel name (torch.profiler), ms,
    largest first; empty when the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            # "void at::native::foo<...>(...)" -> "at::native::foo"
            name = e.key.replace("(anonymous namespace)::", "")
            name = re.split(r"[<(]", name)[0].removeprefix("void ")
            times[name] = times.get(name, 0.0) \
                + e.self_device_time_total / 1e3
    return dict(sorted(times.items(), key=lambda kv: -kv[1]))


def device_time(fn, reps):
    """Mean device milliseconds per fn() call: the kernel time of `reps`
    calls in a torch.profiler trace, without the host's launch overhead
    that CUDA events between launches include; None when the trace holds
    no device time."""
    def run():
        for _ in range(reps):
            fn()

    fn()
    kernels = profile_kernels(run)
    return sum(kernels.values()) / reps if kernels else None


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
    """K1-K5, K7, K8 and K8r vs plain on the first Compressed_BCC chunk
    (8 x 128 x 64)."""
    import torch
    from fitsnap_tpu_torch.calculators.snap import pair_masks
    from fitsnap_tpu_torch.kernels import snap_kernels as sk
    from fitsnap_tpu_torch.ops import snap as ops
    from fitsnap_tpu_torch.ops.cg import build_snap_plan
    from fitsnap_tpu_torch.ops.refpot import zbl_table
    from fitsnap_tpu_torch.parallel import fit

    chunk = [d for d in data if d["Group"] == "Compressed_BCC"][:8]
    packed, buckets = calc.host_preprocess(chunk)
    _, args = next(iter(calc.batches(packed, buckets)))
    disp, jidx, mask, rev, types, natoms, cell = args
    p = calc.params
    C, A, K = mask.shape
    N, U, W, T = C * A, p.u_len, p.ntriples, calc.numtypes
    jelem, smask = pair_masks(p, disp, jidx, mask, types)
    k1_in = (disp.reshape(N, K, 3), jelem.reshape(N, K),
             smask.reshape(N, K), types.reshape(N))
    npairs = int(smask.sum().item())
    print(f"kernel inputs: C={C} A={A} K={K} pairs={npairs} twojmax="
          f"{p.twojmax} float64", flush=True)
    rows = []

    def record(name, out, ref, kernel, plain_ms, nbytes, flops, library_ms):
        """`kernel` is (a call of the wrapper, repetitions to time)."""
        err_abs, err_rel = rel_err(out, ref)
        b_ms, b_by = bound_ms(nbytes, flops)
        ms = timed(*kernel)
        dev_ms = device_time(*kernel)
        print(f"{name}: max_abs_err={err_abs:.3e} max_rel_err={err_rel:.3e}"
              f" ms={ms:.4f} device_ms={dev_ms} plain_ms={plain_ms:.4f}"
              f" bound_ms={b_ms:.4f} ({b_by}) library_ms={library_ms}",
              flush=True)
        if not err_rel <= KERNEL_RTOL:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version ({err_rel:.3e} > {KERNEL_RTOL})")
        src, replaces = SOURCES[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "max_abs_err": err_abs,
                     "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms,
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
           (lambda: sk.pair_u_duals(*k1_in, p), 10),
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

    record("zlist", out, ref, (lambda: sk.zlist(ut, p), 20),
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
    record("dbdd", out, ref, (lambda: sk.dbdd(ut, z_r, z_i, J, p), 10),
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
           (lambda: sk.pair_scatter_rows(*k4_args), 20),
           timed(lambda: sk.pair_scatter_rows_plain(*k4_args), 5),
           k4_bytes, npairs * W * (3 * 2 + 6 * 2),
           timed(lambda: scat.index_add_(0, dest, g_rows), 20))
    del G, g_rows, scat, out, ref

    # K5 on the chunk's host neighbor lists
    table = zbl_table(calc.refspec.zbl, disp.device)
    zc = calc.refspec.zbl
    k5_args = (disp, jidx, mask, types, table, zc.cut_inner, zc.cut_outer)
    out = sk.zbl_pair_grad(*k5_args)
    ref = sk.zbl_pair_grad_plain(*k5_args)
    nlisted = int(mask.sum().item())
    record("zbl_pair_grad", out, ref,
           (lambda: sk.zbl_pair_grad(*k5_args), 20),
           timed(lambda: sk.zbl_pair_grad_plain(*k5_args), 5),
           C * A * K * (24 + 4 + 1 + 24) + C * A * 4 + C * 8 + table.numel()
           * 8, nlisted * 120, None)

    # K8 and K8r on the chunk's positions batch
    s_table = fit.batch_shift_table([pc.cell for pc in packed], calc.cutoff)
    pos_batch = fit.put_batch(fit.pack_batch_pos(
        packed, A, C, s_table, np.float64), disp.device)
    ph, pl, sh, sl, _, nat32 = (x[0] for x in pos_batch[:6])
    S = sh.shape[1]
    k8_args = (ph, pl, sh, sl, nat32, calc.cutoff, K)
    out = sk.device_neighbors(*k8_args)
    ref = sk.device_neighbors_plain(*k8_args)
    if not (torch.equal(out[2], ref[2]) and torch.equal(out[1], ref[1])):
        raise AssertionError("device_neighbors: mask or jidx differs from "
                             "its plain version")
    print(f"device_neighbors: S={S} candidates/atom={S * A} listed="
          f"{int(out[2].sum().item())} (host lists {nlisted})", flush=True)
    record("device_neighbors", out[:1], ref[:1],
           (lambda: sk.device_neighbors(*k8_args), 20),
           timed(lambda: sk.device_neighbors_plain(*k8_args), 3),
           C * A * 3 * 8 * 2 + C * S * 3 * 8 * 2 + C * 4
           + C * A * K * (24 + 4 + 1), C * S * A * A * 11, None)
    _, njidx, nmask = out
    out = sk.reverse_table(njidx, nmask)
    ref = sk.reverse_table_plain(njidx, nmask)
    if not (torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
            and int(out[1].sum().item()) == 0):
        raise AssertionError("reverse_table differs from its plain version "
                             "or dropped entries")
    # the function needs O(A K) integer work, so its bound is its bytes
    record("reverse_table", [x.double() for x in out],
           [x.double() for x in ref],
           (lambda: sk.reverse_table(njidx, nmask), 20),
           timed(lambda: sk.reverse_table_plain(njidx, nmask), 5),
           C * A * K * (4 + 1 + 4) + C * 4, 0, None)
    del out, ref

    # K7 on the chunk's rows, with the truths and weights of the batch
    rows_in = calc.rows(*args)
    truths, weights = pos_batch[7:10], pos_batch[10:13]
    truths, weights = [x[0] for x in truths], [x[0] for x in weights]
    k7_args = (rows_in, truths, weights, nat32, types, T, True, FLAGS)
    out = sk.normal_contrib(*k7_args)
    ref = sk.normal_contrib_plain(*k7_args)
    coeff = torch.linspace(-1.0, 1.0, ref[1].shape[0], dtype=torch.float64,
                           device=disp.device)
    res = sk.normal_contrib(*k7_args, coeff, False)[1]
    res_ref = sk.normal_contrib_plain(*k7_args, coeff, False)[1]
    _, res_err = rel_err([res], [res_ref])
    if not (res_err <= KERNEL_RTOL and out[2].item() == ref[2].item()):
        raise AssertionError(f"normal_contrib: residual mode {res_err:.3e} "
                             f"or nrows differs")
    a_full, _ = sk.full_rows(rows_in, truths, nat32, types, T, True)
    wrow = sk.row_weights(weights, nat32, A, FLAGS)
    aw = (a_full * wrow[..., None]).reshape(-1, a_full.shape[2])
    nrow, Wf = aw.shape
    Wr = rows_in["e_cols"].shape[1]
    record("normal_contrib", out[:2], ref[:2],
           (lambda: sk.normal_contrib(*k7_args), 20),
           timed(lambda: sk.normal_contrib_plain(*k7_args), 5),
           C * (1 + 3 * A + 6) * Wr * 8 + 3 * C * (1 + 3 * A + 6) * 8
           + 3 * C * 8 + C * 4 + C * A * 4 + (Wf * Wf + Wf + 1) * 8,
           nrow * (2 * Wf * Wf + 2 * Wf),
           timed(lambda: torch.mm(aw.T, aw), 20))
    torch.cuda.synchronize()
    return rows


# ---------------------------------------------------------------------------
# FitSnap path
# ---------------------------------------------------------------------------


def main_path(ini, a_plain, beta, device):
    """Drive FitSnap on the card; returns (the FitSnap, launch counts,
    timings, checks)."""
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

    missing = [k for k in FITSNAP_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the FitSnap path: "
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
    return fs, counts, dict(fs.timings), checks


# ---------------------------------------------------------------------------
# streamed path
# ---------------------------------------------------------------------------


def streamed_path(fs, a_plain, beta, seed, device):
    """Drive parallel/fit.py on `device` over FitSnap's configs; returns
    (launch counts, timings, checks)."""
    import torch
    from fitsnap_tpu_torch.calculators.snap import chunk_size
    from fitsnap_tpu_torch.kernels import snap_kernels as sk
    from fitsnap_tpu_torch.parallel import fit

    calc = fs.calculator
    sk.reset_launches()
    t = {}
    t0 = time.time()
    packed = [calc._pack(d) for d in fs.data]
    groups = fit.plan_shift_groups(packed, calc.cutoff)
    runs = []
    for g in groups:
        per = chunk_size(g["a_pad"], g["k_pad"], calc.sec.ncoeff)
        chunks = -(-len(g["configs"]) // per)
        batch = fit.pack_batch_pos(g["configs"], g["a_pad"], chunks * per,
                                   g["s_table"], np.float64, chunks=chunks)
        runs.append(({"cutoff": calc.cutoff, "k_pad": g["k_pad"]}, batch))
        print(f"streamed group: {len(g['configs'])} configs -> {chunks} x "
              f"{per}, a_pad={g['a_pad']} k_pad={g['k_pad']} "
              f"S={len(g['s_table'])}", flush=True)
    t["pack"] = time.time() - t0
    t0 = time.time()
    runs = [(nb, fit.put_batch(batch, device)) for nb, batch in runs]
    torch.cuda.synchronize()
    t["upload"] = time.time() - t0

    model = (calc.params, calc.numtypes, FLAGS, device)
    steps = [fit.build_step_fn(*model, refspec=calc.refspec, neighbors=nb,
                               accumulate=True) for nb, _ in runs]
    residuals = [fit.build_residual_fn(*model, refspec=calc.refspec,
                                       neighbors=nb) for nb, _ in runs]
    evals = [fit.build_eval_fn(*model, refspec=calc.refspec, neighbors=nb)
             for nb, _ in runs]

    def one_pass(_=None):
        acc = steps[0][1]()
        for (acc_step, _, _), (_, batch) in zip(steps, runs):
            acc = acc_step(acc, batch)
        return steps[0][2](acc)

    def residual(x, _=None):
        return sum(res(x, batch) for res, (_, batch) in zip(residuals, runs))

    def evaluate(x):
        return np.sum([ev(x, batch) for ev, (_, batch) in zip(evals, runs)],
                      0)

    t0 = time.time()
    AtA, Atb, nrows = one_pass()
    t["first_pass"] = time.time() - t0
    t0 = time.time()
    for _ in range(3):
        AtA, Atb, nrows = one_pass()
    t["steady_pass"] = (time.time() - t0) / 3
    kernel_ms = profile_kernels(one_pass)
    if kernel_ms:
        t["device_ms_per_pass"] = sum(kernel_ms.values())
        t["device_busy_share"] = t["device_ms_per_pass"] / 1e3 \
            / t["steady_pass"]
    print("streamed pass device time by kernel (ms): " + (json.dumps(
        {k: round(v, 3) for k, v in list(kernel_ms.items())[:12]})
        if kernel_ms else "not measured (no device time in the trace)"),
        flush=True)
    t0 = time.time()
    x_direct = fit.NormalSolver(AtA).solve(Atb)
    t["solve"] = time.time() - t0
    t0 = time.time()
    x_ref, _, _ = fit.fit_refined(one_pass, residual, None, refine_iters=2)
    t["refine"] = time.time() - t0
    rng = np.random.default_rng(seed + 2)
    x_check = x_ref * (1.0 + 1e-3 * rng.normal(size=x_ref.shape))
    t0 = time.time()
    se, ne, sf, nf = evaluate(x_ref)
    t["eval"] = time.time() - t0
    cse, cne, csf, cnf = evaluate(x_check)
    torch.cuda.synchronize()
    counts = sk.launches()
    t["rows_per_s"] = nrows / t["steady_pass"]

    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the streamed "
                             f"path: {missing}")
    if nrows != a_plain.shape[0]:
        raise AssertionError(f"nrows {nrows} != {a_plain.shape[0]}")
    aw = fs.w[:, None] * a_plain
    bw = fs.w * fs.b
    ata_host, atb_host = aw.T @ aw, aw.T @ bw
    ata_err = np.abs(AtA.reshape(ata_host.shape) - ata_host).max() \
        / np.abs(ata_host).max()
    atb_err = np.abs(Atb - atb_host).max() / np.abs(atb_host).max()
    if not (ata_err <= NORMAL_RTOL and atb_err <= NORMAL_RTOL):
        raise AssertionError(f"normal equations differ from the host's: "
                             f"AtA {ata_err:.3e}, Atb {atb_err:.3e}")
    sv = np.linalg.svd(aw, compute_uv=False)
    cond = sv[0] / sv[-1]
    scale = np.abs(beta).max()
    err_direct = np.abs(x_direct - beta).max() / scale
    err_ref = np.abs(x_ref - beta).max() / scale
    tol_direct, tol_ref = 100 * cond ** 2 * EPS64, 100 * cond * EPS64
    if not (err_direct <= tol_direct and err_ref <= tol_ref):
        raise AssertionError(
            f"streamed fit misses beta_true: direct {err_direct:.3e} "
            f"(limit {tol_direct:.3e}), refined {err_ref:.3e} (limit "
            f"{tol_ref:.3e}), cond {cond:.3e}")
    rtype = np.asarray(fs.fs_dict["Row_Type"])
    res = np.abs(a_plain @ x_check - fs.b)
    host = (res[rtype == "Energy"].sum(), (rtype == "Energy").sum(),
            res[rtype == "Force"].sum(), (rtype == "Force").sum())
    mae_err = max(abs(cse - host[0]) / host[0], abs(csf - host[2]) / host[2])
    if not (cne == host[1] and cnf == host[3] and mae_err <= MAE_RTOL):
        raise AssertionError(f"MAE sums differ from the host's: "
                             f"{(cse, cne, csf, cnf)} vs {host}")
    checks = {"groups": len(groups), "nrows": nrows,
              "ata_rel_err": float(ata_err), "atb_rel_err": float(atb_err),
              "cond_weighted_a_all": float(cond),
              "beta_direct_rel_err": float(err_direct),
              "beta_direct_tol": float(tol_direct),
              "beta_refined_rel_err": float(err_ref),
              "beta_refined_tol": float(tol_ref),
              "energy_mae": se / ne, "force_mae": sf / nf,
              "mae_rel_err_at_check": float(mae_err)}
    return counts, t, checks


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
            fs, counts, timings, checks = main_path(ini, a_plain, beta,
                                                    "cuda")
            s_counts, s_times, s_checks = streamed_path(fs, a_plain, beta,
                                                        args.seed, "cuda")
        finally:
            os.chdir(cwd)
    print("FitSnap path stage timings: " + " ".join(
        f"{k}={v:.3f}s" for k, v in timings.items()), flush=True)
    print("FitSnap path checks: " + json.dumps(checks), flush=True)
    print("streamed path timings: " + " ".join(
        f"{k}={v:.4f}" + ("s" if k in ("pack", "upload", "first_pass",
                                       "steady_pass", "solve", "refine",
                                       "eval") else "")
        for k, v in s_times.items()), flush=True)
    print("streamed path checks: " + json.dumps(s_checks), flush=True)
    for row in kernels:
        by_path = {"fitsnap": counts[row["name"]],
                   "streamed": s_counts[row["name"]]}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
