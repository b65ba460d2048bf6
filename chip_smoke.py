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
   K4 also as the ZBL reference calls it, width 1 and one type block; K8
   and K8r on that chunk's positions batch), failing above 1e-11
   relative error (K8's mask and jidx and K8r's table must be equal); kernel,
   plain and library-call times with CUDA events, the kernel's device time
   (and K4's and K7's library call's) from a torch.profiler trace (events
   between launches also count the host's launch overhead, which exceeds
   the small kernels' run time), and
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
   host's from A_plain and b to 1e-10 relative;
6. ACE data: the same configs with the Ta_PACE [ACE] section (ranks 1-6,
   68 labels, 39 A-slots, 1,540 product terms, bzeroflag 0) and truths
   A_plain @ beta_true plus ZBL, A_plain from the plain ACE path;
7. ACE kernels: K13 (ace_pair_basis) and K14 (ace_b_dbdd) against their
   plain versions at the Ta_PACE plan on the first Compressed_BCC chunk
   and at an InP_PACE-shaped two-element plan (344 labels, 99 A-slots,
   an inner cutoff on the In-P bond) on 8 seeded zincblende cells of 64
   atoms, and K7 in the ACE layout (two leading constant columns) on the
   latter's rows, measured as in phase 3;
8. ACE FitSnap and streamed paths, as phases 4 and 5 with
   `calculator = LAMMPSPACE`, PACE output and `kernel=ace_kernel(plan)`.
   The weighted design matrix is too ill-conditioned (cond about 1e16)
   for beta_true to be a check, so the predictions must hold to the
   truths: the weighted residual within 10x what the solver's cutoff can
   leave (lstsq at rcond 1e-13: 1e-13 sigma_max |beta| / |w b|; the
   streamed NormalSolver: sqrt(10 eps) sigma_max |d beta| / |w b| of the
   column-equilibrated matrix, direct and refined), and each row type's
   largest error within 1e-6 of its largest truth.  K13, K14, K4 and K5
   must launch on the FitSnap path, and K7, K8 and K8r too on the
   streamed one;
9. quadratic SNAP data: the same configs with `synthetic.quadratic_settings`
   (twojmax 8, quadraticflag: 55 + 1,540 descriptor columns, 1,596
   coefficients), truths from the plain path; and InP-shaped chemflag data:
   `synthetic.inp_configs` (200 zincblende In/P cells of 8, 64 and 216
   atoms in five groups) with `synthetic.inp_settings` (two elements,
   twojmax 6, wselfallflag, bnormflag, bzeroflag 1, ESHIFT, ZBL 4.0-4.2;
   480 columns), truths from the plain path;
10. quadratic and chemflag kernels, measured as in phase 3: at the quadratic
   model on the first Compressed_BCC config (the main path's chunk there:
   1 x 128 atoms x 64 slots) K1 and K2 at twojmax 8, K3 in its three W
   tiles, K6q (quad_chain) and K4 at width 1,595; at the InP model on the
   main path's first Displaced_ZB64 chunk the chemflag modes of K1, K2 and
   K3 (utot in two element channels, four channel-pair z-lists, seven W
   tiles of the channel-resolved y-list) and K4 at width 240; at both, K7
   on that chunk's rows with seeded truths and weights (width 1,596 with
   one constant column; 480 without), direct and residual;
11. quadratic and chemflag FitSnap paths, as phase 4 (launch counts set to
   0 just before, read just after): K1-K3, K6q, K4, K5 must launch on the
   first, the chemflag K1-K3 with K4 and K5 on the second; A equal to the
   plain path's to 1e-10 per column.  Where cond(weighted A) <= 4.5e7 the
   fit must recover beta_true within 100 cond eps; otherwise (the InP
   columns repeat exactly in chemflag's symmetric blocks) the predictions
   must hold to the truths: the weighted residual within the ACE limit of
   phase 8, each row type's largest error within max(1e-6, 100 cond_kept
   eps) of its largest truth, cond_kept over the singular values lstsq
   keeps.  Then the streamed fit of each, as phase 5 (counts set to 0 just
   before, read just after; K7, K8 and K8r must launch too): the quadratic
   set's Compressed_BCC group (16 cells of 128 atoms, 1,596 columns), all
   of the InP set (480 columns); AtA / Atb against the host's to 1e-10,
   beta_true where cond <= 4.5e7 (phase 5's limits), else the predictions
   with phase 8's streamed residual limit and each row type within
   max(1e-6, 100 cond_kept eps, 2 e_kept), cond_kept over the singular
   values NormalSolver keeps (those of the equilibrated weighted A above
   sqrt(10 eps) of the largest), e_kept that type's error of the host's SVD
   solve that keeps the same directions, direct and refined; as a control,
   the same solve of AtA and Atb rounded to float32 must fail these checks;
12. NN path (precompute mode), on the Ta set of phase 2 with
   `synthetic.nn_settings` (nonlinear 1, [PYTORCH] layer_sizes num_desc 64
   64 1, batch size 4, 10 epochs): launch counts set to 0, then
   FitSnap(device="cuda") -> scrape -> process -> perform_fit ->
   write_output, the counts read just after; it fails unless K1-K5, K12
   and K12T launched, the last epoch's train loss is below the first's and
   the `.pt`, `.mliap.descriptor`, `.mod` and metrics files are written.
   Then K12 and K12T against their plain versions at the largest bucket
   with a minibatch of 4 (1e-11; timed on rotating copies of the inputs,
   more than four L2 sizes, so that G is read from HBM, and once more on
   one repeated input, which L2 holds), the loss gradient with respect to every
   MLP parameter through `NnForce` against autograd through K12's plain
   version (1e-10), central-difference forces (h = 1e-4, host lists and
   K1-K3 on the card at each displaced position) of the trained model
   against its K12 forces on three atoms of two configs (the JAX package's
   bar, 1e-5), the `.pt`'s per-atom energies on one config against
   `evaluate_bucket`'s (1e-10), and a profiler split of one epoch (K12 /
   K12T, the rest of the card's kernels, idle);
13. NN path in the cached mode (the JAX package's default for SNAP
   networks), on the same set with `nn_settings(..., dgrad_mode="cached")`
   and its 10 epochs: launch counts set to 0, then FitSnap(device="cuda")
   -> scrape -> process -> perform_fit -> write_output, the counts read
   just after; it fails unless K4, K5, K8, K8r, K2, K9, K10, K10T, K11,
   K11T and the force gather launched, K1, K3 and K12's contraction did not,
   no bucket holds dB/dD, the last epoch's train loss is below the first's
   and the four files are written.  Then K9, K10, K10T, K11, K11T and the
   gather against their plain versions at the largest bucket with a
   minibatch of 4 (1e-11; timed on rotating copies of the inputs, as K12),
   the loss gradient through `NnCachedForce` against autograd through the
   plain versions (1e-10), the trained model's energies and forces on that
   minibatch against the precompute path's (K1-K3's dB/dD, then K12;
   1e-9), central-difference forces (device neighbor lists, K9 and the
   cached forward at each displaced position) on three atoms of two configs
   (1e-5), and a profiler split of one epoch;
14. the custom pairwise NN (calculator LAMMPSCUSTOM) on the same set with
   `synthetic.custom_settings` (31 Bessel / Gaussian 3-body pair
   descriptors at cutoff 5.0, `num_desc 64 64 1`, batch 4, 10 epochs, the
   raw energies and forces): launch counts set to 0, then
   FitSnap(device="cuda") -> scrape -> process -> perform_fit ->
   write_output, the counts read just after; it fails unless K15, K15V,
   K15T and the force gather launched, the last epoch's train loss is
   below the first's and the `.pt`, metrics and loss files are written.
   Then K15, K15V and K15T (with the gather's transpose, as in training)
   against their plain versions on the largest minibatch (4 x 128 x 64;
   1e-11; timed on rotating copies of the inputs), the loss gradient
   through `PairDescForce` against plain double autograd through the
   plain descriptors on the card (1e-10), central-difference forces (host
   lists and K15 at each displaced position) on three atoms of two configs
   (1e-5), the `.pt`'s per-atom energies and dE/drij on one config against
   the trained model's (the JAX package's 1e-7: standardization is folded
   into layer 1), and a profiler split of one epoch.

The line before the last is the kernel table as JSON (launches per path,
each path's counts set to 0 just before it and read just after); the last
line is {"ok": true, "device": {...}}.  Without a CUDA device, or run where
the package is missing, it exits non-zero and prints no result.
"""

import argparse
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 bandwidth (NVIDIA data sheet)
L2_BYTES = 50 << 20         # H100 SXM L2 cache (NVIDIA data sheet)
FP64_FLOPS = 67e12          # H100 SXM FP64 tensor-core peak (NVIDIA data sheet)
EXP_OPS = 20                # operations of one f64 exp (a software routine)
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
    "ace_pair_basis": ("fitsnap_tpu_torch/kernels/csrc/ace_pair_basis.cu",
                       "fitsnap_tpu/ops/ace.py:589"),
    "ace_b_dbdd": ("fitsnap_tpu_torch/kernels/csrc/ace_b_dbdd.cu",
                   "fitsnap_tpu/ops/ace.py:706"),
    "pair_u_duals_chem": ("fitsnap_tpu_torch/kernels/csrc/pair_u_duals.cu",
                          "fitsnap_tpu/ops/snap.py:769"),
    "zlist_chem": ("fitsnap_tpu_torch/kernels/csrc/zlist.cu",
                   "fitsnap_tpu/ops/snap.py:1005"),
    "dbdd_chem": ("fitsnap_tpu_torch/kernels/csrc/dbdd.cu",
                  "fitsnap_tpu/ops/snap.py:992"),
    "quad_chain": ("fitsnap_tpu_torch/kernels/csrc/quad_chain.cu",
                   "fitsnap_tpu/ops/snap.py:1097"),
    "nn_force": ("fitsnap_tpu_torch/kernels/csrc/nn_force.cu",
                 "fitsnap_tpu/solvers/network.py:720"),
    "nn_force_t": ("fitsnap_tpu_torch/kernels/csrc/nn_force.cu",
                   "fitsnap_tpu/solvers/network.py:720"),
    "nn_pair_gather": ("fitsnap_tpu_torch/kernels/csrc/nn_force.cu",
                       "fitsnap_tpu/solvers/network.py:811"),
    "nn_ut_b": ("fitsnap_tpu_torch/kernels/csrc/nn_grid.cu",
                "fitsnap_tpu/ops/snap.py:352"),
    "nn_dedu_vg": ("fitsnap_tpu_torch/kernels/csrc/nn_dedu.cu",
                   "fitsnap_tpu/ops/snap.py:471"),
    "nn_dedu_vg_t": ("fitsnap_tpu_torch/kernels/csrc/nn_dedu.cu",
                     "fitsnap_tpu/ops/snap.py:471"),
    "nn_pair_force": ("fitsnap_tpu_torch/kernels/csrc/nn_grid.cu",
                      "fitsnap_tpu/ops/snap.py:507"),
    "nn_pair_force_t": ("fitsnap_tpu_torch/kernels/csrc/nn_grid.cu",
                        "fitsnap_tpu/ops/snap.py:544"),
    "pair_desc": ("fitsnap_tpu_torch/kernels/csrc/pair_desc.cu",
                  "fitsnap_tpu/ops/custom_desc.py:67"),
    "pair_desc_vjp": ("fitsnap_tpu_torch/kernels/csrc/pair_desc.cu",
                      "fitsnap_tpu/solvers/network.py:707"),
    "pair_desc_jvp": ("fitsnap_tpu_torch/kernels/csrc/pair_desc.cu",
                      "fitsnap_tpu/solvers/network.py:707"),
}
FITSNAP_KERNELS = ("pair_u_duals", "zlist", "dbdd", "pair_scatter_rows",
                   "zbl_pair_grad")
STREAM_KERNELS = ("normal_contrib", "device_neighbors", "reverse_table")
ACE_KERNELS = ("ace_pair_basis", "ace_b_dbdd", "pair_scatter_rows",
               "zbl_pair_grad")
QUAD_KERNELS = FITSNAP_KERNELS + ("quad_chain",)
CHEM_KERNELS = ("pair_u_duals_chem", "zlist_chem", "dbdd_chem",
                "pair_scatter_rows", "zbl_pair_grad")
NN_KERNELS = FITSNAP_KERNELS + ("nn_force", "nn_force_t")
NN_CACHED_KERNELS = ("pair_scatter_rows", "zbl_pair_grad", "device_neighbors",
                     "reverse_table", "zlist", "nn_ut_b", "nn_dedu_vg",
                     "nn_dedu_vg_t", "nn_pair_force", "nn_pair_force_t",
                     "nn_pair_gather")
# kernels the cached mode must not launch (K1, K3 and K12's contraction)
NN_CACHED_ABSENT = ("pair_u_duals", "dbdd", "nn_force")
CUSTOM_KERNELS = ("pair_desc", "pair_desc_vjp", "pair_desc_jvp",
                  "nn_pair_gather")
# the kernels each path must launch
PATH_KERNELS = {"fitsnap": FITSNAP_KERNELS,
                "streamed": FITSNAP_KERNELS + STREAM_KERNELS,
                "ace_fitsnap": ACE_KERNELS,
                "ace_streamed": ACE_KERNELS + STREAM_KERNELS,
                "quadratic_fitsnap": QUAD_KERNELS,
                "quadratic_streamed": QUAD_KERNELS + STREAM_KERNELS,
                "chem_fitsnap": CHEM_KERNELS,
                "chem_streamed": CHEM_KERNELS + STREAM_KERNELS,
                "nn_fitsnap": NN_KERNELS,
                "nn_cached_fitsnap": NN_CACHED_KERNELS,
                "custom_fitsnap": CUSTOM_KERNELS}
# FitSnap and streamed paths of each data set
FITSNAP_PATH = {"snap": "fitsnap", "ace": "ace_fitsnap",
                "quadratic": "quadratic_fitsnap", "inp": "chem_fitsnap"}
STREAM_PATH = {"snap": "streamed", "ace": "ace_streamed",
               "quadratic": "quadratic_streamed", "inp": "chem_streamed"}
# the groups the streamed fit runs of each set (None: all of them)
STREAM_GROUPS = {"snap": None, "ace": None, "quadratic": ["Compressed_BCC"],
                 "inp": None}
FLAGS = {"energy": True, "force": True, "stress": True}
# the InP_PACE example's shape (two elements, ranks 1-4: 344 labels, 99
# A-slots, 2,136 product terms) with an inner cutoff on the In-P bond
INP_SHAPE = dict(numtypes=2, ranks=[1, 2, 3, 4], lmax=[1, 2, 2, 1],
                 nmax=[22, 3, 2, 1], lmin=[0, 0, 1, 1], nmaxbase=22,
                 rcutfac=[5.5] * 4, lmbda=[3.0] * 4,
                 rcinner=[0.0, 2.4, 2.4, 0.0],
                 drcinner=[0.01, 0.5, 0.5, 0.01], b_basis="minsub")
SVD_RCOND = 1e-13           # singular-value cutoff of solvers/svd.SVD
PRED_RTOL = 1e-6            # predictions vs truths, per row type
# streamed fits vs the host's SVD solve keeping NormalSolver's directions,
# per row type: the card's read at most 1.104x it (PERF.md)
KEPT_FACTOR = 2.0
BETA_COND = 4.5e7           # beta_true is a check where 100 cond eps <= 1e-6
GRAD_RTOL = 1e-10           # NN loss gradient through NnForce vs plain K12
FD_H = 1e-4                 # central-difference step of the NN force check
FD_BAR = 1e-5               # the JAX package's NN FD-force bar (README.md)
PT_RTOL = 1e-10             # exported .pt energies vs evaluate_bucket
CROSS_RTOL = 1e-9           # NN cached vs precompute energies and forces
NN_FILES = ["Ta_nn.pt", "Ta_nn_pot.mliap.descriptor", "Ta_nn_pot.mod",
            "Ta_nn_metrics.md", "loss_vs_epochs.dat"]
CUSTOM_FILES = ["Ta_custom.pt", "Ta_custom_metrics.md", "loss_vs_epochs.dat"]
PAIR_PT_RTOL = 1e-7         # pairwise .pt vs the model (the JAX test's bar)
# operations of one (j, k) pair's Gaussian term in K15, K15V, K15T: the
# exp, the square and the weighted sums (K15V: both legs' sums; K15T: the
# cosine tangent)
GAUSS_OPS = {"pair_desc": EXP_OPS + 4, "pair_desc_vjp": EXP_OPS + 10,
             "pair_desc_jvp": EXP_OPS + 8}


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


def reset_launches():
    from fitsnap_tpu_torch.kernels import ace_kernels as ak
    from fitsnap_tpu_torch.kernels import custom_kernels as ck
    from fitsnap_tpu_torch.kernels import nn_kernels as nk
    from fitsnap_tpu_torch.kernels import snap_kernels as sk

    sk.reset_launches()
    ak.reset_launches()
    nk.reset_launches()
    ck.reset_launches()


def launches():
    """{kernel wrapper: launches since the last reset}, every kernel."""
    from fitsnap_tpu_torch.kernels import ace_kernels as ak
    from fitsnap_tpu_torch.kernels import custom_kernels as ck
    from fitsnap_tpu_torch.kernels import nn_kernels as nk
    from fitsnap_tpu_torch.kernels import snap_kernels as sk

    return dict(sk.launches(), **ak.launches(), **nk.launches(),
                **ck.launches())


def check_launched(counts, path):
    missing = [k for k in PATH_KERNELS[path] if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {path} path: "
                             f"{missing}")


def record(rows, name, out, ref, kernel, plain_ms, nbytes, flops,
           library_ms, wrapper=None, shape=None, library=None):
    """Hold a kernel's outputs to its plain version's, time it, and add its
    row to `rows`.  `kernel` is (a call of the wrapper, repetitions to
    time); `wrapper` names the kernel when the row is one of several
    shapes of it; `library`, a call of the library function, is timed
    here, by CUDA events (in place of `library_ms`) and by device time."""
    err_abs, err_rel = rel_err(out, ref)
    b_ms, b_by = bound_ms(nbytes, flops)
    ms = timed(*kernel)
    dev_ms = device_time(*kernel)
    lib_dev_ms = None
    if library:
        library_ms = timed(library, 20)
        lib_dev_ms = device_time(library, 20)
    print(f"{name}: max_abs_err={err_abs:.3e} max_rel_err={err_rel:.3e}"
          f" ms={ms:.4f} device_ms={dev_ms} plain_ms={plain_ms:.4f}"
          f" bound_ms={b_ms:.4f} ({b_by}) library_ms={library_ms}"
          f" library_device_ms={lib_dev_ms}", flush=True)
    if not err_rel <= KERNEL_RTOL:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version ({err_rel:.3e} > {KERNEL_RTOL})")
    wrapper = wrapper or name
    src, replaces = SOURCES[wrapper]
    row = {"name": name, "kernel": wrapper, "route": "cuda", "source": src,
           "replaces": replaces, "max_abs_err": err_abs,
           "max_rel_err": err_rel, "ms": ms, "device_ms": dev_ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": library_ms}
    if library:
        row["library_device_ms"] = lib_dev_ms
    if shape:
        row["shape"] = shape
    rows.append(row)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def make_dataset(tmp, seed, device, kind="snap"):
    """Write the synthetic set with truths A_plain @ beta_true + ZBL, for
    the SNAP model (`kind="snap"`, the Ta_Linear_JCP2014 sections), the ACE
    one ("ace", the Ta_PACE section), quadratic SNAP ("quadratic", the
    Ta_Quadratic_JCP2018 width) on the Ta-shaped configs, or the InP_JPCA2020
    chemflag model ("inp") on the InP-shaped configs.

    Returns (input file, the FitSnap that computed A_plain, its scraped
    data, A_plain, beta_true, seconds of the plain path on the card)."""
    import torch
    from fitsnap_tpu_torch import FitSnap
    from fitsnap_tpu_torch.tools import synthetic

    folder, settings, beta_seed, configs = {
        "snap": ("JSON", synthetic.ta_settings, seed + 1,
                 synthetic.ta_configs),
        "ace": ("ACE_JSON", synthetic.ace_settings, seed + 3,
                synthetic.ta_configs),
        "quadratic": ("QUAD_JSON", synthetic.quadratic_settings, seed + 7,
                      synthetic.ta_configs),
        "inp": ("INP_JSON", synthetic.inp_settings, seed + 8,
                synthetic.inp_configs)}[kind]
    root = Path(tmp) / folder
    files = synthetic.write_dataset(root, configs(seed))
    ini = Path(tmp) / f"{kind}.in"
    synthetic.write_ini(ini, settings(root))

    fs0 = FitSnap(str(ini), arglist=["--overwrite"], device=device)
    data = fs0.scrape_configs()
    t0 = time.time()
    a, b0, _, _ = fs0.calculator.process_configs(data, plain=True)
    torch.cuda.synchronize()
    t_plain = time.time() - t0
    rng = np.random.default_rng(beta_seed)
    beta = rng.normal(size=a.shape[1])
    natoms = [d["NumAtoms"] for d in data]
    for d, (e, f, s) in zip(data, synthetic.truths_from_rows(
            a, b0, beta, natoms)):
        conf = files[(d["Group"], d["File"])]
        (root / d["Group"] / d["File"]).write_text(synthetic.config_json(
            conf[0], conf[1], e, f, s,
            types=conf[2] if len(conf) > 2 else None))
    return ini, fs0, data, a, beta, t_plain


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


def snap_chunk(calc, data, group, configs=None):
    """The main path's first chunk of `group` (of its first `configs`
    configs when given): (the packed configs, rows() arguments, the K1
    inputs and the live SNAP pairs' mask (C, A, K))."""
    from fitsnap_tpu_torch.calculators.snap import pair_masks

    chunk = [d for d in data if d["Group"] == group][:configs]
    packed, buckets = calc.host_preprocess(chunk)
    _, args = next(iter(calc.batches(packed, buckets)))
    disp, jidx, mask, rev, types, natoms, cell = args
    C, A, K = mask.shape
    N = C * A
    jelem, smask = pair_masks(calc.params, disp, jidx, mask, types)
    k1_in = (disp.reshape(N, K, 3), jelem.reshape(N, K),
             smask.reshape(N, K), types.reshape(N))
    return packed, args, k1_in, smask


def descriptor_checks(rows, p, k1_in, shape=None):
    """K1, K2 and K3 (their chemflag modes when the plan has element
    channels) and K6q (quadraticflag) against their plain versions on one
    chunk's K1 inputs; rows are named `kernel@shape` when a shape is given.
    Returns the plain (B, dB/dD) the chunk's rows are built from."""
    import torch
    from fitsnap_tpu_torch.kernels import snap_kernels as sk
    from fitsnap_tpu_torch.ops import snap as ops
    from fitsnap_tpu_torch.ops.cg import build_snap_plan

    N, K = k1_in[2].shape
    npairs = int(k1_in[2].sum().item())
    U, nc, W = p.u_len, p.nchem, p.nb_base
    chem = nc > 1
    sfx = "_chem" if chem else ""
    at = f"@{shape}" if shape else ""

    def name(kernel):
        return kernel + sfx if kernel != "quad_chain" else kernel

    # K1: per live pair the prologue (about 600 flops), the monomial chain
    # with tangents (10 per monomial), the change of basis (8 per nonzero of
    # L) and the outputs (11 per U column)
    k1 = getattr(sk, "pair_u_duals" + sfx)
    out = k1(*k1_in, p)
    ref = sk.pair_u_duals_plain(*k1_in, p)
    k1_flops = npairs * ((p.mono_parent.shape[0] - 1) * 10
                         + p.l_val.shape[0] * 8 + 2 * U * 11 + 600)
    k1_bytes = N * K * (3 * 8 + 4 + 1) + N * 4 + 4 * N * K * 2 * U * 8 \
        + N * nc * 2 * U * 8
    record(rows, name("pair_u_duals") + at, out, ref,
           (lambda: k1(*k1_in, p), 10),
           timed(lambda: sk.pair_u_duals_plain(*k1_in, p), 3),
           k1_bytes, k1_flops, None, wrapper=name("pair_u_duals"),
           shape=shape)
    wu, J, ut = ref
    del out, wu

    # K2 (every ordered channel pair in one launch), with torch.bmm over the
    # TPU path's dense term GEMMs as library call for one channel
    k2 = getattr(sk, "zlist" + sfx)
    k2_plain = getattr(sk, "zlist" + sfx + "_plain")
    out = k2(ut, p)
    ref = k2_plain(ut, p)
    library = None
    if not chem:
        dense = []
        for g in build_snap_plan(p.twojmax).z_dense["groups"]:
            gi1 = torch.as_tensor(g["gi1"], device=ut.device).long()
            gi2 = torch.as_tensor(g["gi2"], device=ut.device).long()
            a_r, a_i = ut[:, :U][:, gi1], ut[:, U:][:, gi1]
            b_r, b_i = ut[:, :U][:, gi2], ut[:, U:][:, gi2]
            dense.append(
                ((a_r * b_r - a_i * b_i).transpose(0, 1).contiguous(),
                 (a_r * b_i + a_i * b_r).transpose(0, 1).contiguous(),
                 torch.as_tensor(g["M"], device=ut.device)))
        library = timed(lambda: [(torch.bmm(pr, M), torch.bmm(pi, M))
                                 for pr, pi, M in dense], 20)
        del dense
    record(rows, name("zlist") + at, out, ref, (lambda: k2(ut, p), 20),
           timed(lambda: k2_plain(ut, p), 5),
           N * nc * 2 * U * 8 + 2 * N * nc * nc * p.nz * 8,
           N * nc * nc * p.z_c.shape[0] * 10, library, wrapper=name("zlist"),
           shape=shape)
    z_r, z_i = ref
    del out

    # K3 in W tiles, with the JAX form's einsum as library call
    jel = k1_in[1]
    if chem:
        def k3():
            return sk.dbdd_chem(ut, z_r, z_i, J, jel, p)

        def k3_plain():
            return sk.dbdd_chem_plain(ut, z_r, z_i, J, jel, p)

        _, dbdu = ops._chem_b_and_dbdu(ut, p, (z_r, z_i))
        oh = torch.nn.functional.one_hot(jel.long(), nc).to(J.dtype)
        # (N, W, 2U, K) is the einsum's intermediate when it contracts
        # left to right
        inter = N * W * 2 * U * K * 8
        library = (timed(lambda: torch.einsum("awnu,akn,caku->awkc", dbdu,
                                              oh, J), 3)
                   if inter < torch.cuda.mem_get_info()[0] // 2 else None)
        if library is None:
            print(f"dbdd_chem library call not timed: its {inter / 1e9:.1f}"
                  f" GB intermediate exceeds half the free memory",
                  flush=True)
    else:
        def k3():
            return sk.dbdd(ut, z_r, z_i, J, p)

        def k3_plain():
            return sk.dbdd_plain(ut, z_r, z_i, J, p)

        dbdu = ops._dbdu_ylist(ut, p, (z_r, z_i))
        library = timed(lambda: torch.einsum("awu,caku->awkc", dbdu, J), 10)
    out, ref = k3(), k3_plain()
    k3_flops = N * W * U * 16 + npairs * W * 3 * 2 * U * 2
    k3_bytes = (N * nc * 2 * U + 2 * N * nc * nc * p.nz + 3 * N * K * 2 * U
                + N * W + N * W * K * 3) * 8 + (N * K * 4 if chem else 0)
    ntiles = sk.dbdd_tiles(p)[1]
    record(rows, name("dbdd") + at, out, ref, (k3, 10), timed(k3_plain, 3),
           k3_bytes, k3_flops, library, wrapper=name("dbdd"),
           shape=f"{shape}, {ntiles} W tiles" if shape else None)
    B, G = ref
    del out, dbdu, J
    torch.cuda.empty_cache()

    if p.quadraticflag:
        # K6q: no single PyTorch call forms the product rule, so no
        # library time
        out = sk.quad_chain(B, G, p)
        ref = sk.quad_chain_plain(B, G, p)
        nq = p.iq1.shape[0]
        X = W + nq
        record(rows, "quad_chain" + at, out, ref,
               (lambda: sk.quad_chain(B, G, p), 10),
               timed(lambda: sk.quad_chain_plain(B, G, p), 3),
               (N * W + N * W * K * 3 + N * X + N * X * K * 3) * 8
               + nq * 16, N * nq * (K * 3 * 4 + 2), None,
               wrapper="quad_chain", shape=shape)
        B, G = ref
        del out
        torch.cuda.empty_cache()
    return B, G


def scatter_check(rows, args, smask, G, T, shape=None, types=None):
    """K4 against its plain version on one chunk's per-pair gradients G
    (N, X, K, 3), with index_add_ of the neighbor scatter as library
    call; `types` replaces the chunk's (the ZBL call passes all zeros)."""
    import torch
    from fitsnap_tpu_torch.kernels import snap_kernels as sk

    disp, jidx, mask, rev, chunk_types, natoms, cell = args
    types = chunk_types if types is None else types
    C, A, K = mask.shape
    N, X = C * A, G.shape[1]
    npairs = int(smask.sum().item())
    real = (torch.arange(A, device=disp.device)[None, :]
            < natoms[:, None]).to(disp.dtype)
    G = (G.reshape(C, A, X, K, 3) * real[..., None, None, None]).contiguous()
    k4_args = (G, disp, smask, rev, types, T)
    out = sk.pair_scatter_rows(*k4_args)
    ref = sk.pair_scatter_rows_plain(*k4_args)
    dest = (torch.arange(C, device=disp.device)[:, None, None] * A
            + jidx.long())[smask]
    g_rows = G.permute(0, 1, 3, 2, 4)[smask].reshape(-1, X * 3)
    scat = torch.zeros((N, X * 3), dtype=G.dtype, device=G.device)
    k4_bytes = (G.numel() + disp.numel() + C * A * 3 * T * X
                + C * 6 * T * X) * 8 + smask.numel() + rev.numel() * 4 \
        + types.numel() * 4
    record(rows, "pair_scatter_rows" + (f"@{shape}" if shape else ""), out,
           ref, (lambda: sk.pair_scatter_rows(*k4_args), 20),
           timed(lambda: sk.pair_scatter_rows_plain(*k4_args), 5),
           k4_bytes, npairs * X * (3 * 2 + 6 * 2),
           None, wrapper="pair_scatter_rows",
           shape=f"{shape}, width {X}" if shape else None,
           library=lambda: scat.index_add_(0, dest, g_rows))
    del G, g_rows, scat, out, ref
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def normal_check(rows, rows_in, truths, weights, natoms, types, T, const,
                 layout="snap", shape=None):
    """K7 against its plain version on one chunk's rows, direct and in the
    residual mode (at seeded coefficients), with torch.mm(Awᵀ, Aw) of the
    weighted full rows as library call; the row is named
    `normal_contrib@shape` when a shape is given."""
    import torch
    from fitsnap_tpu_torch.kernels import snap_kernels as sk

    k7_args = (rows_in, truths, weights, natoms, types, T, const, FLAGS)
    out = sk.normal_contrib(*k7_args, None, True, layout)
    ref = sk.normal_contrib_plain(*k7_args, None, True, layout)
    Wf = ref[1].shape[0]
    coeff = torch.linspace(-1.0, 1.0, Wf, dtype=torch.float64,
                           device=types.device)
    res = sk.normal_contrib(*k7_args, coeff, False, layout)
    res_ref = sk.normal_contrib_plain(*k7_args, coeff, False, layout)
    _, res_err = rel_err(res[1:2], res_ref[1:2])
    print(f"normal_contrib ({layout} layout, width {Wf}): residual mode "
          f"max_rel_err={res_err:.3e}", flush=True)
    if not (res_err <= KERNEL_RTOL and out[2].item() == ref[2].item()
            and res[2].item() == ref[2].item() and not res[0].any()):
        raise AssertionError(f"normal_contrib ({layout} layout, width "
                             f"{Wf}): residual mode {res_err:.3e}, nrows "
                             f"or AtA differs")
    a_full, _ = sk.full_rows(rows_in, truths, natoms, types, T, const,
                             layout)
    C, A = types.shape
    wrow = sk.row_weights(weights, natoms, A, FLAGS)
    aw = (a_full * wrow[..., None]).reshape(-1, Wf)
    nrow = aw.shape[0]
    Wr = rows_in["e_cols"].shape[1]
    # AtA is symmetric: its upper triangle, Wf (Wf + 1) / 2 multiply-adds a
    # row, and Atb's Wf; the bytes count the full AtA written
    record(rows, "normal_contrib" + (f"@{shape}" if shape else ""),
           out[:2], ref[:2],
           (lambda: sk.normal_contrib(*k7_args, None, True, layout), 20),
           timed(lambda: sk.normal_contrib_plain(*k7_args, None, True,
                                                 layout), 5),
           C * (1 + 3 * A + 6) * Wr * 8 + 3 * C * (1 + 3 * A + 6) * 8
           + 3 * C * 8 + C * 4 + C * A * 4 + (Wf * Wf + Wf + 1) * 8,
           nrow * (Wf * (Wf + 1) + 2 * Wf), None, wrapper="normal_contrib",
           shape=f"{shape}, {layout} layout, width {Wf}" if shape else None,
           library=lambda: torch.mm(aw.T, aw))
    del out, ref, res, res_ref, a_full, aw
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def seeded_truths(seed, C, A, device):
    """Seeded truths (energy, forces, stress6) and weights of C configs."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g,
                           dtype=torch.float64).to(device)

    return ((rnd(C), rnd(C, A, 3), rnd(C, 6)),
            (rnd(C).abs(), rnd(C).abs(), rnd(C).abs()))


def kernel_checks(calc, data):
    """K1-K5, K7, K8 and K8r vs plain on the first Compressed_BCC chunk
    (8 x 128 x 64)."""
    import torch
    from fitsnap_tpu_torch.kernels import snap_kernels as sk
    from fitsnap_tpu_torch.ops.refpot import zbl_table
    from fitsnap_tpu_torch.parallel import fit

    packed, args, k1_in, smask = snap_chunk(calc, data, "Compressed_BCC", 8)
    disp, jidx, mask, rev, types, natoms, cell = args
    p = calc.params
    C, A, K = mask.shape
    T = calc.numtypes
    print(f"kernel inputs: C={C} A={A} K={K} pairs="
          f"{int(smask.sum().item())} twojmax={p.twojmax} float64",
          flush=True)
    rows = []
    B, G = descriptor_checks(rows, p, k1_in)
    scatter_check(rows, args, smask, G, T)
    del B, G

    # K5 on the chunk's host neighbor lists
    table = zbl_table(calc.refspec.zbl, disp.device)
    zc = calc.refspec.zbl
    k5_args = (disp, jidx, mask, types, table, zc.cut_inner, zc.cut_outer)
    out = sk.zbl_pair_grad(*k5_args)
    ref = sk.zbl_pair_grad_plain(*k5_args)
    nlisted = int(mask.sum().item())
    record(rows, "zbl_pair_grad", out, ref,
           (lambda: sk.zbl_pair_grad(*k5_args), 20),
           timed(lambda: sk.zbl_pair_grad_plain(*k5_args), 5),
           C * A * K * (24 + 4 + 1 + 24) + C * A * 4 + C * 8 + table.numel()
           * 8, nlisted * 120, None)
    # K4 as the ZBL reference calls it: width 1, one type block, every
    # listed pair
    g_zbl = ref[0].reshape(C * A, 1, K, 3)
    scatter_check(rows, args, mask, g_zbl, 1, "ZBL", torch.zeros_like(types))

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
    record(rows, "device_neighbors", out[:1], ref[:1],
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
    record(rows, "reverse_table", [x.double() for x in out],
           [x.double() for x in ref],
           (lambda: sk.reverse_table(njidx, nmask), 20),
           timed(lambda: sk.reverse_table_plain(njidx, nmask), 5),
           C * A * K * (4 + 1 + 4) + C * 4, 0, None)
    del out, ref

    # K7 on the chunk's rows, with the truths and weights of the batch
    rows_in = calc.rows(*args)
    truths, weights = pos_batch[7:10], pos_batch[10:13]
    truths, weights = [x[0] for x in truths], [x[0] for x in weights]
    normal_check(rows, rows_in, truths, weights, nat32, types, T, True)
    return rows


def inp_chunk(seed, plan, device, configs=8):
    """A seeded two-element chunk: `configs` jittered zincblende InP cells
    of 64 atoms (In on the fcc sites, type 0; P on the shifted ones, type
    1), with host neighbor lists at the plan's largest cutoff.  Returns
    (disp, jidx, mask, rev, types, natoms, cell) on `device`, as the rows
    functions take them."""
    import torch
    from fitsnap_tpu_torch.kernels import snap_kernels as sk
    from fitsnap_tpu_torch.ops.neighbors import host_neighbors
    from fitsnap_tpu_torch.tools import synthetic

    rng = np.random.default_rng(seed + 5)
    basis = np.concatenate([synthetic.FCC, synthetic.FCC + 0.25])
    cutoff = float(np.max(plan.rcut))
    cells, lists = [], []
    for _ in range(configs):
        pos, cell = synthetic.supercell(basis, rng.uniform(5.75, 5.95),
                                        (2, 2, 2))
        pos = pos + rng.normal(0.0, 0.15, pos.shape)
        cells.append(cell)
        lists.append(host_neighbors(pos, cell, len(pos), cutoff))
    A = len(lists[0][0])
    K = -(-max(kc for *_, kc in lists) // 8) * 8
    disp = np.zeros((configs, A, K, 3))
    jidx = np.zeros((configs, A, K), np.int32)
    mask = np.zeros((configs, A, K), bool)
    for c, (d, j, m, kc) in enumerate(lists):
        disp[c, :, :kc], jidx[c, :, :kc], mask[c, :, :kc] = d, j, m
    types = np.tile(np.repeat([0, 1], 4), A // 8).astype(np.int32)

    def put(x):
        return torch.as_tensor(x, device=device)

    jidx, mask = put(jidx), put(mask)
    rev, dropped = sk.reverse_table_plain(jidx, mask)
    if int(dropped.sum().item()):
        raise AssertionError("InP chunk: reverse table dropped entries")
    return (put(disp), jidx, mask, rev,
            put(np.broadcast_to(types, (configs, A)).copy()),
            put(np.full(configs, A, np.int32)), put(np.stack(cells)))


def ace_pair_checks(rows, plan, disp, jelem, smask, types, shape):
    """K13 and K14 against their plain versions on one chunk."""
    import torch
    from fitsnap_tpu_torch.kernels import ace_kernels as ak
    from fitsnap_tpu_torch.ops import ace as ops

    C, A, K = smask.shape
    N = C * A
    nA, nl, nrad = plan.nA, len(plan.labels), plan.nradbase
    ny, R = (plan.lmax + 1) ** 2, plan.rank_max
    k13_in = (disp.reshape(N, K, 3), jelem.reshape(N, K),
              smask.reshape(N, K), types.reshape(N))
    npairs = int(smask.sum().item())
    tabs = ak.kernel_tables(plan)
    print(f"ACE kernel inputs ({shape}): C={C} A={A} K={K} pairs={npairs} "
          f"labels={nl} A-slots={nA} terms={len(plan.t_coef)} rank={R} "
          f"dB/dA entries={tabs.nE} float64", flush=True)
    suffix = "" if shape == "Ta_PACE" else f"@{shape}"

    # K13: per live pair the radial recursion (about 20 flops per n) and
    # the Ylm recursion with its gradient (about 60 per (l, m)), then 16 per
    # A-slot (phi and three tangents, re and im)
    out = ak.ace_pair_basis(*k13_in, plan)
    ref = ak.ace_pair_basis_plain(*k13_in, plan)
    record(rows, "ace_pair_basis" + suffix, out, ref,
           (lambda: ak.ace_pair_basis(*k13_in, plan), 10),
           timed(lambda: ak.ace_pair_basis_plain(*k13_in, plan), 3),
           N * K * (24 + 4 + 1) + N * 4 + N * 2 * nA * 8
           + 3 * N * K * 2 * nA * 8 + nA * 16,
           npairs * (20 * nrad + 60 * ny + 16 * nA), None,
           wrapper="ace_pair_basis", shape=shape)
    A_, Jp = ref
    ielem = k13_in[3]
    del out

    # K14: work of the labels whose central element is the atom's: per term
    # R - 1 complex products (6 flops) and its coefficient (2), per
    # contribution to dB/dA the cofactor's R - 2 products and 4, per live
    # pair, label entry and direction 4 (re and im multiply-adds)
    out = ak.ace_b_dbdd(A_, Jp, ielem, plan)
    ref = ak.ace_b_dbdd_plain(A_, Jp, ielem, plan)
    mu0 = np.asarray(plan.t_mu0)
    n_terms = np.diff(tabs.lab_t)
    n_entries = np.diff(tabs.lab_e)
    n_contrib = tabs.e_c[tabs.lab_e[1:]] - tabs.e_c[tabs.lab_e[:-1]]
    flops = 0
    per_atom_pairs = smask.reshape(N, K).sum(1).cpu().numpy()
    elems = ielem.cpu().numpy()
    for e in range(plan.numtypes):
        live = mu0 == e
        atoms = int((elems == e).sum())
        pairs = int(per_atom_pairs[elems == e].sum())
        flops += atoms * (int(n_terms[live].sum()) * (6 * (R - 1) + 2)
                          + int(n_contrib[live].sum()) * (6 * max(R - 2, 0)
                                                          + 4))
        flops += pairs * int(n_entries[live].sum()) * 3 * 4
    _, dbda = ops.ace_b_and_dbda(A_[:, :nA], A_[:, nA:], plan)
    table_bytes = (len(plan.t_coef) * (R * 4 + 8) + nl * 4 * 3
                   + tabs.nE * 8 + tabs.nC * 4 + (plan.numtypes + 1) * 4)
    record(rows, "ace_b_dbdd" + suffix, out, ref,
           (lambda: ak.ace_b_dbdd(A_, Jp, ielem, plan), 10),
           timed(lambda: ak.ace_b_dbdd_plain(A_, Jp, ielem, plan), 3),
           N * 2 * nA * 8 + 3 * N * K * 2 * nA * 8 + N * 4 + N * nl * 8
           + N * nl * K * 3 * 8 + table_bytes, flops,
           timed(lambda: torch.einsum("alp,cakp->alkc", dbda, Jp), 10),
           wrapper="ace_b_dbdd", shape=shape)
    del out, ref, dbda


def ace_kernel_checks(calc, data, seed):
    """K13 and K14 vs plain at the Ta_PACE plan on the first Compressed_BCC
    chunk (8 x 128 x 64) and at the InP-shaped plan on a seeded two-element
    chunk (8 x 64 atoms), and K7 in the ACE layout (two leading constant
    columns) on the rows of the latter."""
    import torch
    from fitsnap_tpu_torch.calculators.ace import _within_rcut, ace_rows
    from fitsnap_tpu_torch.kernels import snap_kernels as sk
    from fitsnap_tpu_torch.ops.ace import build_ace_plan
    from fitsnap_tpu_torch.ops.refpot import RefSpec

    rows = []
    chunk = [d for d in data if d["Group"] == "Compressed_BCC"][:8]
    packed, buckets = calc.host_preprocess(chunk)
    _, (disp, jidx, mask, _, types, _, _) = next(iter(
        calc.batches(packed, buckets)))
    dev = disp.device
    jelem, inside = _within_rcut(disp, jidx, types, calc.plan)
    ace_pair_checks(rows, calc.plan, disp, jelem, mask & inside, types,
                    "Ta_PACE")
    del disp, jidx, mask, jelem, inside
    torch.cuda.empty_cache()

    plan = build_ace_plan(SimpleNamespace(**INP_SHAPE))
    batch = inp_chunk(seed, plan, dev)
    disp, jidx, mask, rev, types, natoms, cell = batch
    jelem, inside = _within_rcut(disp, jidx, types, plan)
    smask = mask & inside
    r = torch.sqrt((disp * disp).sum(-1))
    mixed = smask & (jelem != types[:, :, None])
    ramp = int((mixed & (r > 1.9) & (r < 2.4)).sum().item())
    print(f"InP chunk: {ramp} In-P pairs inside the inner ramp "
          f"[1.9, 2.4] A", flush=True)
    if not ramp:
        raise AssertionError("InP chunk: no pair inside the inner ramp")
    del r, mixed
    ace_pair_checks(rows, plan, disp, jelem, smask, types, "InP_shape")

    # K7 in the ACE layout on the chunk's plain rows, with seeded truths
    # and weights
    rows_in = ace_rows(plan, RefSpec(), *batch, plain=True)
    C, A = types.shape
    truths, weights = seeded_truths(seed + 6, C, A, dev)
    normal_check(rows, rows_in, truths, weights, natoms, types,
                 plan.numtypes, True, "ace", "ace")
    return rows


def flag_kernel_checks(calc, data, kind, seed):
    """The kernels of the quadratic ("quadratic") or chemflag ("inp") path
    against their plain versions on the main path's first chunk of a group
    (Compressed_BCC, Displaced_ZB64): K1-K3 (chemflag modes), K6q, K4, and
    K7 on the chunk's rows."""
    import torch
    from fitsnap_tpu_torch.kernels import snap_kernels as sk

    group = {"quadratic": "Compressed_BCC", "inp": "Displaced_ZB64"}[kind]
    shape = {"quadratic": "Ta_Quadratic", "inp": "InP"}[kind]
    _, args, k1_in, smask = snap_chunk(calc, data, group)
    C, A, K = smask.shape
    p = calc.params
    wt, ntiles = sk.dbdd_tiles(p)
    print(f"{shape} kernel inputs: C={C} A={A} K={K} pairs="
          f"{int(smask.sum().item())} twojmax={p.twojmax} channels="
          f"{p.nchem} base width={p.nb_base} width={calc.desc_width()} "
          f"K3 tiles={ntiles} x {wt} rows float64", flush=True)
    rows = []
    B, G = descriptor_checks(rows, p, k1_in, shape)
    scatter_check(rows, args, smask, G, calc.numtypes, shape)
    del B, G
    # K7 on the chunk's rows (the streamed fit's width), seeded truths
    rows_in = calc.rows(*args)
    natoms, types = args[5].to(torch.int32), args[4]
    truths, weights = seeded_truths(seed + 9, C, A, types.device)
    normal_check(rows, rows_in, truths, weights, natoms, types,
                 calc.numtypes, not calc.sec.bzeroflag, "snap", shape)
    return rows


# ---------------------------------------------------------------------------
# FitSnap path
# ---------------------------------------------------------------------------


def prediction_errors(a, x, b, row_type):
    """max |a x - b| / max |b| per row type."""
    res = np.abs(a @ x - b)
    return {k: float(res[row_type == k].max() / np.abs(b[row_type == k]).max())
            for k in ("Energy", "Force", "Stress")}


def check_predictions(tag, aw, bw, x, limit, per_type, pred_limit=PRED_RTOL):
    """Weighted residual of x within `limit`, and each row type within
    `pred_limit` (one value, or one per row type); returns the weighted
    residual."""
    resid = np.linalg.norm(aw @ x - bw) / np.linalg.norm(bw)
    lim = pred_limit if isinstance(pred_limit, dict) \
        else dict.fromkeys(per_type, pred_limit)
    if not (np.isfinite(x).all() and resid <= limit
            and all(per_type[k] <= lim[k] for k in per_type)):
        raise AssertionError(
            f"{tag}: predictions miss the truths: weighted residual "
            f"{resid:.3e} (limit {limit:.3e}), per row type {per_type} "
            f"(limit {lim})")
    return float(resid)


def main_path(ini, a_plain, beta, device, kind="snap"):
    """Drive FitSnap on the card; returns (the FitSnap, launch counts,
    timings, checks).  SNAP ("snap"): the fit must recover beta_true.  ACE
    ("ace"), whose weighted design matrix is too ill-conditioned for that:
    the predictions must hold to the truths.  Quadratic SNAP and chemflag
    ("quadratic", "inp"): beta_true where cond(weighted A) <= BETA_COND,
    else the predictions."""
    import torch
    from fitsnap_tpu_torch import FitSnap

    reset_launches()
    t0 = time.time()
    fs = FitSnap(str(ini), arglist=["--overwrite"], device=device)
    fs.scrape_configs()
    fs.process_configs()
    fs.perform_fit()
    fs.write_output()
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launches()

    check_launched(counts, FITSNAP_PATH[kind])
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
    checks = {"rows": int(fs.a.shape[0]), "width": int(fs.a.shape[1]),
              "configs": len(set(fs.fs_dict["Configs"])),
              "a_rel_err": float(a_err), "cond_weighted_a": float(cond)}
    pot = fs.config.sections["OUTFILE"].potential_name
    if kind != "ace":
        sec = fs.config.sections["BISPECTRUM"]
        head = Path(pot + ".snapcoeff").read_text().splitlines()[2].split()
        want = [str(sec.numtypes), str(sec.ncoeff + 1)]
        cols = sec.numtypes * (sec.ncoeff + (0 if sec.bzeroflag else 1))
        if head != want or cols != a_plain.shape[1]:
            raise AssertionError(f".snapcoeff header {head} (want {want}) "
                                 f"or width {a_plain.shape[1]} != {cols}")
    if kind == "snap" or (kind != "ace" and cond <= BETA_COND):
        beta_tol = 100 * cond * EPS64
        beta_err = np.abs(fs.fit - beta).max() / np.abs(beta).max()
        if not (np.isfinite(fs.fit).all() and beta_err <= beta_tol):
            raise AssertionError(f"fit misses beta_true: {beta_err:.3e} > "
                                 f"{beta_tol:.3e} (cond {cond:.3e})")
        # the truths are A @ beta_true, so the weighted residual is rounding
        resid = np.linalg.norm(aw @ fs.fit - bw) / np.linalg.norm(bw)
        if not resid <= RESID_RTOL:
            raise AssertionError(f"weighted residual {resid:.3e} > "
                                 f"{RESID_RTOL}")
        checks.update(beta_rel_err=float(beta_err), beta_tol=float(beta_tol),
                      resid_rel=float(resid))
    else:
        # truths = A_plain beta_true; lstsq at rcond SVD_RCOND drops
        # directions whose part of w b is at most rcond sigma_max |beta|
        limit = 10 * SVD_RCOND * sv[0] * np.linalg.norm(beta) \
            / np.linalg.norm(bw)
        per_type = prediction_errors(fs.a, fs.fit, fs.b,
                                     np.asarray(fs.fs_dict["Row_Type"]))
        pred_limit = PRED_RTOL
        if kind != "ace":
            # rows the weights barely hold are predicted only as well as
            # the solve's forward error over the kept singular values
            kept = sv[sv > SVD_RCOND * sv[0]]
            pred_limit = max(PRED_RTOL, 100 * kept[0] / kept[-1] * EPS64)
            checks["cond_kept"] = float(kept[0] / kept[-1])
        resid = check_predictions("FitSnap", aw, bw, fs.fit, limit, per_type,
                                  pred_limit)
        if kind == "ace":
            text = Path(pot + ".acecoeff").read_text()
            sec = fs.config.sections["ACE"]
            if not (text.count("#  mu0=") == len(fs.calculator.plan.labels)
                    and text.count("#  const") == (0 if sec.bzeroflag
                                                   else sec.numtypes)
                    and "E0: [" in Path(pot + ".yace").read_text()
                    and Path(pot + ".mod").exists()):
                raise AssertionError("the .acecoeff, .yace or .mod is wrong")
        checks.update(resid_rel=resid, resid_limit=float(limit),
                      pred_rel_err=per_type, pred_limit=float(pred_limit))
    # rsq is -inf by definition for a row group with constant truths, so
    # only ncount, mae and rmse must be finite
    errs = fs.solver.errors
    if not (len(errs) and np.isfinite(errs.values[:, :3]).all()):
        raise AssertionError("empty or non-finite error table")
    checks["wall_s"] = wall
    return fs, counts, dict(fs.timings), checks


# ---------------------------------------------------------------------------
# streamed path
# ---------------------------------------------------------------------------


def streamed_path(fs, a_plain, beta, seed, device, kind="snap"):
    """Drive parallel/fit.py on `device` over FitSnap's configs of the
    kind's STREAM_GROUPS, with the SNAP model of the set ("snap",
    "quadratic", "inp") or, through `ace_kernel`, the ACE one ("ace");
    returns (launch counts, timings, checks)."""
    import torch
    from fitsnap_tpu_torch.calculators.snap import chunk_size
    from fitsnap_tpu_torch.parallel import fit

    calc = fs.calculator
    groups = STREAM_GROUPS[kind]
    data = [d for d in fs.data if groups is None or d["Group"] in groups]
    sel = np.ones(len(fs.b), bool) if groups is None \
        else np.isin(np.asarray(fs.fs_dict["Groups"]), groups)
    a_plain, w_rows, b_rows = a_plain[sel], fs.w[sel], fs.b[sel]
    rtype = np.asarray(fs.fs_dict["Row_Type"])[sel]
    reset_launches()
    t = {}
    t0 = time.time()
    packed = [calc._pack(d) for d in data]
    shape_groups = fit.plan_shift_groups(packed, calc.cutoff)
    runs = []
    for g in shape_groups:
        per = chunk_size(g["a_pad"], g["k_pad"], calc.desc_width())
        chunks = -(-len(g["configs"]) // per)
        batch = fit.pack_batch_pos(g["configs"], g["a_pad"], chunks * per,
                                   g["s_table"], np.float64, chunks=chunks)
        runs.append(({"cutoff": calc.cutoff, "k_pad": g["k_pad"]}, batch))
        print(f"streamed group ({kind}): {len(g['configs'])} configs -> "
              f"{chunks} x {per}, a_pad={g['a_pad']} k_pad={g['k_pad']} "
              f"S={len(g['s_table'])}", flush=True)
    t["pack"] = time.time() - t0
    t0 = time.time()
    runs = [(nb, fit.put_batch(batch, device)) for nb, batch in runs]
    torch.cuda.synchronize()
    t["upload"] = time.time() - t0

    if kind != "ace":
        model, kw = (calc.params, calc.numtypes, FLAGS, device), {}
    else:
        model = (None, calc.numtypes, FLAGS, device)
        kw = {"kernel": fit.ace_kernel(calc.plan),
              "const_mode": False if calc.sec.bzeroflag
              else ("ace", calc.numtypes)}
    kw["refspec"] = calc.refspec
    steps = [fit.build_step_fn(*model, neighbors=nb, accumulate=True, **kw)
             for nb, _ in runs]
    residuals = [fit.build_residual_fn(*model, neighbors=nb, **kw)
                 for nb, _ in runs]
    evals = [fit.build_eval_fn(*model, neighbors=nb, **kw) for nb, _ in runs]

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
    print(f"streamed pass ({kind}) device time by kernel (ms): " + (json.dumps(
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
    counts = launches()
    t["rows_per_s"] = nrows / t["steady_pass"]

    check_launched(counts, STREAM_PATH[kind])
    if nrows != a_plain.shape[0]:
        raise AssertionError(f"nrows {nrows} != {a_plain.shape[0]}")
    aw = w_rows[:, None] * a_plain
    bw = w_rows * b_rows
    ata_host, atb_host = aw.T @ aw, aw.T @ bw
    ata_err = np.abs(AtA.reshape(ata_host.shape) - ata_host).max() \
        / np.abs(ata_host).max()
    atb_err = np.abs(Atb - atb_host).max() / np.abs(atb_host).max()
    if not (ata_err <= NORMAL_RTOL and atb_err <= NORMAL_RTOL):
        raise AssertionError(f"normal equations differ from the host's: "
                             f"AtA {ata_err:.3e}, Atb {atb_err:.3e}")
    sv = np.linalg.svd(aw, compute_uv=False)
    cond = sv[0] / sv[-1]
    checks = {"configs": len(data), "shape_groups": len(runs),
              "width": int(a_plain.shape[1]), "nrows": nrows,
              "ata_rel_err": float(ata_err), "atb_rel_err": float(atb_err),
              "cond_weighted_a_all": float(cond)}
    if kind == "snap" or (kind != "ace" and cond <= BETA_COND):
        scale = np.abs(beta).max()
        err_direct = np.abs(x_direct - beta).max() / scale
        err_ref = np.abs(x_ref - beta).max() / scale
        tol_direct, tol_ref = 100 * cond ** 2 * EPS64, 100 * cond * EPS64
        if not (err_direct <= tol_direct and err_ref <= tol_ref):
            raise AssertionError(
                f"streamed fit misses beta_true: direct {err_direct:.3e} "
                f"(limit {tol_direct:.3e}), refined {err_ref:.3e} (limit "
                f"{tol_ref:.3e}), cond {cond:.3e}")
        checks.update(beta_direct_rel_err=float(err_direct),
                      beta_direct_tol=float(tol_direct),
                      beta_refined_rel_err=float(err_ref),
                      beta_refined_tol=float(tol_ref))
    else:
        # NormalSolver equilibrates the columns (norms d) and drops
        # eigenvalues below 10 eps of the largest: singular values below
        # sqrt(10 eps) of the largest, whose part of w b is at most that
        # times |d beta|; rounding in A^T A moves the kept ones by as much
        d = np.sqrt(np.clip(np.diag(ata_host), 1e-300, None))
        if kind == "ace":
            sn = np.linalg.svd(aw / d, compute_uv=False)
        else:
            u, sn, vt = np.linalg.svd(aw / d, full_matrices=False)
        limit = 10 * np.sqrt(10 * EPS64) * sn[0] \
            * np.linalg.norm(d * beta) / np.linalg.norm(bw)
        pred_limit = PRED_RTOL
        if kind != "ace":
            # phase 11's limit over the singular values NormalSolver keeps
            # (those of the equilibrated matrix above sqrt(10 eps) of the
            # largest); the truths may also reach into the directions it
            # drops, so no solve that keeps the same directions does better
            # than the host's SVD solve that does (e_kept): each row type
            # is held to the larger of the two, e_kept times KEPT_FACTOR
            kept = sn >= np.sqrt(10 * EPS64) * sn[0]
            cond_kept = sn[kept][0] / sn[kept][-1]
            x_kept = vt[kept].T @ ((u[:, kept].T @ bw) / sn[kept]) / d
            kept_err = prediction_errors(a_plain, x_kept, b_rows, rtype)
            pred_limit = {k: max(PRED_RTOL, 100 * cond_kept * EPS64,
                                 KEPT_FACTOR * v)
                          for k, v in kept_err.items()}
            checks.update(cond_kept=float(cond_kept),
                          pred_rel_err_kept_svd=kept_err)
            del u, vt
        fits = [("direct", x_direct), ("refined", x_ref)]
        for tag, x in fits:
            per_type = prediction_errors(a_plain, x, b_rows, rtype)
            checks[f"resid_rel_{tag}"] = check_predictions(
                f"streamed {tag}", aw, bw, x, limit, per_type, pred_limit)
            checks[f"pred_rel_err_{tag}"] = per_type
        if kind != "ace":
            # control: the same solve on AtA and Atb rounded to float32
            # (what a float32 accumulation would deliver) must fail
            x32 = fit.NormalSolver(np.asarray(AtA, np.float32)).solve(
                np.asarray(Atb, np.float32))
            per_type = prediction_errors(a_plain, x32, b_rows, rtype)
            checks["pred_rel_err_f32_control"] = per_type
            try:
                check_predictions("float32 control", aw, bw, x32, limit,
                                  per_type, pred_limit)
            except AssertionError:
                pass
            else:
                raise AssertionError(f"the float32 control passed the "
                                     f"streamed checks: {per_type}")
        checks["pred_limit"] = pred_limit
        checks["resid_limit"] = float(limit)
    res = np.abs(a_plain @ x_check - b_rows)
    host = (res[rtype == "Energy"].sum(), (rtype == "Energy").sum(),
            res[rtype == "Force"].sum(), (rtype == "Force").sum())
    mae_err = max(abs(cse - host[0]) / host[0], abs(csf - host[2]) / host[2])
    if not (cne == host[1] and cnf == host[3] and mae_err <= MAE_RTOL):
        raise AssertionError(f"MAE sums differ from the host's: "
                             f"{(cse, cne, csf, cnf)} vs {host}")
    checks.update(energy_mae=se / ne, force_mae=sf / nf,
                  mae_rel_err_at_check=float(mae_err))
    return counts, t, checks


# ---------------------------------------------------------------------------
# NN path (precompute mode)
# ---------------------------------------------------------------------------


def nn_path(tmp, device, mode="precompute"):
    """Drive the NN fit through FitSnap on the card on the Ta set of phase
    2 in `mode` (precompute, cached, or custom: the pairwise NN); returns
    (the FitSnap, launch counts, timings, checks)."""
    import torch
    from fitsnap_tpu_torch import FitSnap
    from fitsnap_tpu_torch.tools import synthetic

    ini = Path(tmp) / f"nn_{mode}.in"
    data = Path(tmp) / "JSON"
    files = CUSTOM_FILES if mode == "custom" else NN_FILES
    synthetic.write_ini(ini, synthetic.custom_settings(data)
                        if mode == "custom" else
                        synthetic.nn_settings(data, dgrad_mode=mode))
    for name in files:
        Path(name).unlink(missing_ok=True)
    reset_launches()
    t0 = time.time()
    fs = FitSnap(str(ini), arglist=["--overwrite"], device=device)
    fs.scrape_configs()
    fs.process_configs()
    fs.perform_fit()
    fs.write_output()
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launches()
    sol = fs.solver
    if mode == "custom":
        check_launched(counts, "custom_fitsnap")
    elif mode == "cached":
        check_launched(counts, "nn_cached_fitsnap")
        stray = {k: counts[k] for k in NN_CACHED_ABSENT if counts[k]}
        if stray or not sol.cached or any("G" in b for b in sol.buckets):
            raise AssertionError(f"the cached NN path launched {stray} or "
                                 f"stored dB/dD")
    else:
        check_launched(counts, "nn_fitsnap")

    hist = np.array(sol.history)
    print("nn loss curve (epoch, train, validation): "
          + json.dumps(hist.tolist()), flush=True)
    print("nn seconds per epoch: " + json.dumps(sol.epoch_times), flush=True)
    if not (np.isfinite(hist).all() and hist[-1, 1] < hist[0, 1]):
        raise AssertionError(f"NN train loss did not fall: {hist[:, 1]}")
    missing = [f for f in files
               if not (Path(f).exists() and Path(f).stat().st_size)]
    errs = sol.errors
    if missing or not (len(errs) and np.isfinite(errs.values).all()):
        raise AssertionError(f"NN outputs missing {missing} or the error "
                             f"table is empty or not finite")
    checks = {"configs": len(fs.data),
              "buckets": {str(b["shape"]): len(b["groups"])
                          for b in sol.buckets},
              "train_loss_first": hist[0, 1], "train_loss_last": hist[-1, 1],
              "val_loss_last": hist[-1, 2],
              "g_bytes": sum(b["G"].numel() * 8 for b in sol.buckets
                             if "G" in b),
              "cached_bytes": sum(b[k].numel() * b[k].element_size()
                                  for b in sol.buckets if "ut" in b
                                  for k in ("disp", "jidx", "mask", "rev",
                                            "ut", "B")),
              "pair_bytes": sum(b[k].numel() * b[k].element_size()
                                for b in sol.buckets if mode == "custom"
                                for k in ("disp", "jidx", "mask", "rev")),
              "errors": {f"{g}/{t}": dict(zip(errs.columns, map(float, v)))
                         for (g, t), v in zip(errs.index, errs.values)
                         if g == "*ALL"}}
    times = dict(fs.timings, wall=wall,
                 epoch_first=sol.epoch_times[0],
                 epoch_mean_rest=float(np.mean(sol.epoch_times[1:])))
    return fs, counts, times, checks


def nn_batch(sol, n=4):
    """A minibatch of the first n configs of the largest bucket, with the
    trained model's dE/dB (K12's input)."""
    import torch

    bi = int(np.argmax([np.prod(b["shape"]) for b in sol.buckets]))
    batch = sol._gather(sol.buckets[bi],
                        np.arange(min(n, len(sol.buckets[bi]["groups"]))))
    x = ((batch["B"] - sol.mean) / sol.std).requires_grad_(True)
    e = (sol.model(x, batch["types"]) * batch["real"].to(x.dtype)).sum()
    dEdB = (torch.autograd.grad(e, x)[0] / sol.std).contiguous()
    return batch, dEdB


def rotating(fn, args):
    """fn over copies of `args` in turn, enough copies that each call's
    inputs were last touched more than four L2 sizes of reads earlier: the
    kernel reads them from HBM, as its bytes bound assumes."""
    nbytes = sum(t.numel() * t.element_size() for t in args)
    copies = [tuple(t.clone() for t in args)
              for _ in range(-(-4 * L2_BYTES // nbytes) + 1)]
    nxt = itertools.cycle(copies).__next__
    return lambda: fn(*nxt())


def nn_kernel_checks(fs):
    """K12 and K12T against their plain versions on a minibatch of 4 at
    the largest bucket, and the loss gradient through NnForce against
    autograd through K12's plain version."""
    import torch
    from fitsnap_tpu_torch.kernels import nn_kernels as nk
    from fitsnap_tpu_torch.solvers import network as tnet

    sol = fs.solver
    batch, dEdB = nn_batch(sol)
    G, jidx, rev = batch["G"], batch["jidx"], batch["rev"]
    N, A, W, K, _ = G.shape
    R = rev.shape[2]
    print(f"nn kernel inputs: N={N} A={A} W={W} K={K} R={R} pairs="
          f"{int((rev >= 0).sum().item())} float64", flush=True)
    # timed on rotating copies of the inputs, so that G comes from HBM as
    # the bound assumes; `device_ms_l2` is the call on one repeated input,
    # which L2 holds, as it holds a minibatch just gathered in training
    rows = []
    args = (dEdB, G, jidx, rev)
    out = nk.nn_force(*args)
    ref = nk.nn_force_plain(*args)
    g_bytes = G.numel() * 8
    record(rows, "nn_force", [out], [ref], (rotating(nk.nn_force, args), 20),
           timed(rotating(nk.nn_force_plain, args), 10),
           g_bytes + dEdB.numel() * 8 + rev.numel() * 4 + N * A * 3 * 8,
           2 * G.numel() + N * A * (K + R) * 3, None)
    rows[-1]["device_ms_l2"] = device_time(lambda: nk.nn_force(*args), 20)
    gF = ((ref - batch["f_target"])
          * batch["real"][..., None].to(ref.dtype)).contiguous()
    args = (gF, G, jidx)
    out = nk.nn_force_t(*args)
    ref = nk.nn_force_t_plain(*args)
    record(rows, "nn_force_t", [out], [ref],
           (rotating(nk.nn_force_t, args), 20),
           timed(rotating(nk.nn_force_t_plain, args), 10),
           g_bytes + gF.numel() * 8 + jidx.numel() * 4 + dEdB.numel() * 8,
           2 * G.numel() + N * A * K * 3, None)
    rows[-1]["device_ms_l2"] = device_time(lambda: nk.nn_force_t(*args), 20)

    # the parameter gradient of the training loss: NnForce (K12, backward
    # K12T) against autograd through the plain K12
    leaves = list(sol.model.parameters())

    def grads():
        return torch.autograd.grad(sol._loss(sol.model, batch, train=True),
                                   leaves)

    out = grads()
    cls = tnet.NnForce
    tnet.NnForce = SimpleNamespace(apply=nk.nn_force_plain)
    try:
        ref = grads()
    finally:
        tnet.NnForce = cls
    _, grad_err = rel_err(out, ref)
    print(f"nn loss gradient through NnForce vs plain autograd: "
          f"{grad_err:.3e} (limit {GRAD_RTOL})", flush=True)
    if not grad_err <= GRAD_RTOL:
        raise AssertionError(f"NN loss gradient through NnForce differs "
                             f"from the plain one: {grad_err:.3e}")
    return rows, {"grad_rel_err": grad_err}


def nn_model_eval(sol, calc, pos, cell, types):
    """Energy and K12 forces of one config: host lists, then K1-K3 and the
    MLP on the card."""
    import torch
    from fitsnap_tpu_torch.calculators.snap import pair_masks
    from fitsnap_tpu_torch.ops.neighbors import (host_neighbors,
                                                 reverse_neighbors)
    from fitsnap_tpu_torch.ops.snap import descriptors_with_jacobian

    n = len(pos)
    disp, jidx, mask, _ = host_neighbors(pos, cell, n, calc.cutoff)
    rev = reverse_neighbors(jidx, mask, n)

    def put(x):
        return torch.as_tensor(x, device=calc.device)[None]

    types = put(np.asarray(types, np.int32))
    disp, jidx, mask = put(disp), put(jidx), put(mask)
    jelem, smask = pair_masks(calc.params, disp, jidx, mask, types)
    K = mask.shape[2]
    B, G = descriptors_with_jacobian(disp[0], jelem[0], smask[0], types[0],
                                     calc.params)
    batch = {"B": B[None], "G": G.reshape(1, n, -1, K, 3),
             "types": torch.zeros_like(types),
             "real": torch.ones((1, n), dtype=torch.bool,
                                device=calc.device),
             "nat": torch.tensor([n], device=calc.device),
             "jidx": jidx, "rev": put(rev)}
    e, f = sol._forward_batch(sol.model, batch)
    return float(e[0]) * n, f[0].cpu().numpy()


def nn_fd_check(fs):
    """Central-difference forces of the trained model against its K12
    forces on three atoms of two configs (a displaced 54-atom bcc cell and
    a 100-atom liquid-like one)."""
    sol, calc = fs.solver, fs.calculator
    worst = []
    for group in ("Displaced_BCC", "Liquid"):
        d = [x for x in fs.data if x["Group"] == group][0]
        pos = np.asarray(d["Positions"], float)
        cell = np.asarray(d["Lattice"], float)
        types = [calc.type_mapping[t] - 1 for t in d["AtomTypes"]]
        _, f0 = nn_model_eval(sol, calc, pos, cell, types)
        for a in (0, len(pos) // 2, len(pos) - 1):
            for c in range(3):
                pp, pm = pos.copy(), pos.copy()
                pp[a, c] += FD_H
                pm[a, c] -= FD_H
                ep, _ = nn_model_eval(sol, calc, pp, cell, types)
                em, _ = nn_model_eval(sol, calc, pm, cell, types)
                worst.append(abs(-(ep - em) / (2 * FD_H) - f0[a, c]))
    err = float(np.max(worst))
    print(f"nn FD forces (h={FD_H}): max error {err:.3e}, mean "
          f"{float(np.mean(worst)):.3e} (bar {FD_BAR})", flush=True)
    if not err < FD_BAR:
        raise AssertionError(f"NN FD forces miss the bar: {err:.3e}")
    return {"fd_max_err": err, "fd_mean_err": float(np.mean(worst)),
            "fd_bar": FD_BAR}


def nn_export_check(fs):
    """The written .pt's per-atom energies on one config against the
    model's and evaluate_bucket's."""
    import torch

    sol = fs.solver
    ds = sol.buckets[-1]
    nat = int(ds["nat_host"][0])
    B = ds["B"][0, :nat]
    model = torch.load("Ta_nn.pt", weights_only=False)
    beta, energy = np.zeros(tuple(B.shape)), np.zeros(nat)
    model(np.zeros(nat, np.int32), B.cpu().numpy().copy(), beta, energy)
    with torch.no_grad():
        atoms = sol.model((B - sol.mean) / sol.std,
                          torch.zeros(nat, dtype=torch.int32,
                                      device=B.device)).cpu().numpy()
    e, _ = sol.evaluate_bucket(ds)
    err = max(np.abs(energy - atoms).max() / np.abs(atoms).max(),
              abs(energy.sum() / nat - e[0]) / abs(e[0]))
    print(f"nn exported .pt vs the model: {err:.3e} (limit {PT_RTOL})",
          flush=True)
    if not err <= PT_RTOL:
        raise AssertionError(f"the exported .pt disagrees: {err:.3e}")
    return {"pt_rel_err": float(err)}


def nn_epoch_profile(fs, epoch_s):
    """Device time of one training epoch by kernel (torch.profiler), split
    into the port's kernels (K12 / K12T; cached: K2, K10, K10T, K11, K11T
    and the gather; pairwise: K15, K15V, K15T and the gather), the other
    kernels (MLP, its double backward, gathers,
    Adam), and its share of `epoch_s`, the unprofiled epoch's seconds."""
    net = fs.solver.net
    epochs = net.num_epochs
    net.num_epochs = 1
    try:
        kernels = profile_kernels(lambda: fs.solver.perform_fit())
    finally:
        net.num_epochs = epochs
    if not kernels:
        return {"epoch_profile": "not measured (no device time)"}
    ours = sum(v for k, v in kernels.items()
               if k.startswith(("nn_", "zlist", "pair_desc")))
    total = sum(kernels.values())
    print("nn epoch device time by kernel (ms): " + json.dumps(
        {k: round(v, 3) for k, v in list(kernels.items())[:12]}),
        flush=True)
    return {"epoch_device_ms": total, "epoch_port_kernels_ms": ours,
            "epoch_other_kernels_ms": total - ours,
            "device_busy_share": total / 1e3 / epoch_s}


def nn_cached_batch(sol, n=4):
    """A minibatch of the first n configs of the cached mode's largest
    bucket, with the trained model's dE/dB (N*A, W) and the pair-kernel
    inputs flat over the (N*A) atoms."""
    import torch

    bi = int(np.argmax([np.prod(b["shape"]) for b in sol.buckets]))
    batch = sol._gather(sol.buckets[bi],
                        np.arange(min(n, len(sol.buckets[bi]["groups"]))))
    N, A, K = batch["jidx"].shape
    B = batch["B"]
    x = ((B - sol.mean) / sol.std).reshape(N * A, -1).requires_grad_(True)
    e = (sol.model(x, batch["elem"].reshape(-1))
         * batch["real"].reshape(-1).to(x.dtype)).sum()
    dEdB = (torch.autograd.grad(e, x)[0] / sol.std).contiguous()
    jelem, smask = sol._kit["pair"](batch["disp"], batch["jidx"],
                                    batch["mask"], batch["types"])
    block = (batch["disp"].reshape(N * A, K, 3), jelem.reshape(N * A, K),
             smask.reshape(N * A, K), batch["types"].reshape(N * A))
    return batch, dEdB, block


def nn_cached_kernel_checks(fs):
    """K9, K10, K10T, K11, K11T and the force gather against their plain
    versions on a minibatch of 4 at the cached mode's largest bucket, and
    the loss gradient through NnCachedForce against autograd through the
    plain versions."""
    import torch
    from fitsnap_tpu_torch.kernels import nn_kernels as nk
    from fitsnap_tpu_torch.kernels import snap_kernels as sk
    from fitsnap_tpu_torch.ops.snap import nn_tables
    from fitsnap_tpu_torch.solvers import network as tnet

    sol = fs.solver
    p = sol._snap
    tb = nn_tables(p)
    batch, dEdB, block = nn_cached_batch(sol)
    N, A, K = batch["jidx"].shape
    M, n_t, W, U = N * A, tb.n_t, p.ntriples, p.u_len
    rev = batch["rev"]
    pairs = int(block[2].sum().item())
    print(f"nn cached kernel inputs: N={N} A={A} K={K} W={W} 2U={2 * U} "
          f"n_t={n_t} live pairs={pairs} float64", flush=True)
    nlg, ny = tb.lgc_val.numel(), tb.yu_fac.numel()
    nterms = tb.bt_c.numel()
    pair_in = M * K * (3 * 8 + 4 + 1) + M * 4        # disp, jelem, mask, ielem
    rows = []

    def lg_mm(x, transpose=False):
        """torch.mm with the dense Lg: the basis change alone, as the
        yardstick of one library call (no one call computes a whole
        kernel's function)."""
        Lg = tb.Lg2.T.contiguous() if transpose else tb.Lg2
        return timed(rotating(lambda y: torch.mm(y, Lg), (x,)), 20)

    # K9: per live pair about 3 n_t^2 flops of accumulation and 600 of
    # prologue and powers; per atom 2 per Lg entry and 12 per B term
    ut, B = nk.nn_ut_b_plain(*block, sol._snap)
    record(rows, "nn_ut_b", list(nk.nn_ut_b(*block, p)), [ut, B],
           (rotating(lambda *a: nk.nn_ut_b(*a, p), block), 20),
           timed(rotating(lambda *a: nk.nn_ut_b_plain(*a, p), block), 5),
           pair_in + M * (2 * U + W) * 8,
           pairs * (3 * n_t * n_t + 600) + M * (2 * nlg + 12 * nterms), None)
    rows[-1]["lg_mm_ms"] = lg_mm(torch.zeros((M, n_t * n_t),
                                             dtype=torch.float64,
                                             device=ut.device) + 1.0)
    z = sk.zlist(batch["ut"].reshape(M, -1), p)

    # K10: 5 flops per y entry, 2 per Lg entry, per atom
    args = (dEdB,) + tuple(z)
    vg = nk.nn_dedu_vg_plain(*args, p)
    record(rows, "nn_dedu_vg", [nk.nn_dedu_vg(*args, p)], [vg],
           (rotating(lambda *a: nk.nn_dedu_vg(*a, p), args), 20),
           timed(rotating(lambda *a: nk.nn_dedu_vg_plain(*a, p), args), 5),
           M * (W + 2 * p.nz + n_t * n_t) * 8, M * (5 * ny + 2 * nlg), None)
    rows[-1]["lg_mm_ms"] = lg_mm(torch.ones((M, 2 * U), dtype=torch.float64,
                                            device=vg.device), True)

    # K11: per live pair 8 n_t^2 flops (four bilinear forms) and 600
    args = (vg,) + block
    g = nk.nn_pair_force_plain(*args, p)
    record(rows, "nn_pair_force", [nk.nn_pair_force(*args, p)], [g],
           (rotating(lambda *a: nk.nn_pair_force(*a, p), args), 20),
           timed(rotating(lambda *a: nk.nn_pair_force_plain(*a, p), args), 5),
           pair_in + M * n_t * n_t * 8 + M * K * 3 * 8,
           pairs * (8 * n_t * n_t + 600), None)

    # the gather: one add per slot and component
    args = (g.reshape(N, A, K, 3), rev)
    F = nk.nn_pair_gather_plain(*args)
    record(rows, "nn_pair_gather", [nk.nn_pair_gather(*args)], [F],
           (rotating(nk.nn_pair_gather, args), 20),
           timed(rotating(nk.nn_pair_gather_plain, args), 10),
           M * K * 3 * 8 + rev.numel() * 4 + M * 3 * 8,
           M * 3 * (K + rev.shape[2]), None)

    # K11T on the force residual: per live pair 4 n_t^2 flops and 600
    gF = ((F - batch["f_target"])
          * batch["real"][..., None].to(F.dtype)).contiguous()
    args = (gF, batch["jidx"]) + block
    vgc = nk.nn_pair_force_t_plain(*args, p)
    record(rows, "nn_pair_force_t", [nk.nn_pair_force_t(*args, p)], [vgc],
           (rotating(lambda *a: nk.nn_pair_force_t(*a, p), args), 20),
           timed(rotating(lambda *a: nk.nn_pair_force_t_plain(*a, p), args),
                 5),
           M * 3 * 8 + M * K * 4 + pair_in + M * n_t * n_t * 8,
           pairs * (4 * n_t * n_t + 600), None)

    # K10T: 2 flops per Lg entry, 5 per y entry, per atom
    args = (vgc,) + tuple(z)
    ref = nk.nn_dedu_vg_t_plain(*args, p)
    record(rows, "nn_dedu_vg_t", [nk.nn_dedu_vg_t(*args, p)], [ref],
           (rotating(lambda *a: nk.nn_dedu_vg_t(*a, p), args), 20),
           timed(rotating(lambda *a: nk.nn_dedu_vg_t_plain(*a, p), args), 5),
           M * (n_t * n_t + 2 * p.nz + W) * 8, M * (2 * nlg + 5 * ny), None)
    rows[-1]["lg_mm_ms"] = lg_mm(vgc.reshape(M, -1))

    # the loss gradient: NnCachedForce against autograd through the plain
    # versions
    leaves = list(sol.model.parameters())

    def grads():
        return torch.autograd.grad(sol._loss(sol.model, batch, train=True),
                                   leaves)

    def plain(dEdB, ut, disp, jidx, jelem, mask, ielem, rev, p):
        vg = nk.nn_dedu_vg_plain(dEdB, *sk.zlist_plain(ut, p), p)
        g = nk.nn_pair_force_plain(vg, disp, jelem, mask, ielem, p)
        return nk.nn_pair_gather_plain(g.reshape(jidx.shape + (3,)), rev)

    out = grads()
    cls = tnet.NnCachedForce
    tnet.NnCachedForce = SimpleNamespace(apply=plain)
    try:
        ref = grads()
    finally:
        tnet.NnCachedForce = cls
    _, grad_err = rel_err(out, ref)
    print(f"nn cached loss gradient through NnCachedForce vs plain "
          f"autograd: {grad_err:.3e} (limit {GRAD_RTOL})", flush=True)
    if not grad_err <= GRAD_RTOL:
        raise AssertionError(f"NN cached loss gradient differs from the "
                             f"plain one: {grad_err:.3e}")
    return rows, {"grad_rel_err": grad_err}


def nn_cross_mode_check(fs):
    """The trained cached model's energies and forces on a minibatch of 4
    (the largest bucket) against the precompute path's on the same configs
    and lists: B and dB/dD from K1-K3 (`nn_prep`), forces through K12."""
    sol, calc = fs.solver, fs.calculator
    batch, _, _ = nn_cached_batch(sol)
    e, f = sol._forward_batch_cached(sol.model, batch)
    B, G, _, _ = calc.nn_prep(batch["disp"], batch["jidx"], batch["mask"],
                              batch["rev"], batch["types"], batch["nat"])
    pre = {"B": B, "G": G, "types": batch["elem"], "real": batch["real"],
           "nat": batch["nat"], "jidx": batch["jidx"], "rev": batch["rev"]}
    e_pre, f_pre = sol._forward_batch(sol.model, pre)
    _, b_err = rel_err([batch["B"]], [B])
    _, err = rel_err([e, f], [e_pre, f_pre])
    print(f"nn cached vs precompute on one minibatch: B {b_err:.3e}, "
          f"energies and forces {err:.3e} (limit {CROSS_RTOL})", flush=True)
    if not (err <= CROSS_RTOL and b_err <= CROSS_RTOL):
        raise AssertionError(f"NN cached and precompute modes disagree: "
                             f"B {b_err:.3e}, E/F {err:.3e}")
    return {"cross_mode_rel_err": err, "cross_mode_b_rel_err": b_err}


def nn_cached_eval(sol, calc, pos, cell, types):
    """Energy and cached-mode forces of one config: device neighbor lists
    (K8, K8r), K9, then the cached forward (K2, K10, K11, the gather)."""
    import torch
    from fitsnap_tpu_torch.calculators.snap import PackedConfig
    from fitsnap_tpu_torch.kernels import snap_kernels as sk
    from fitsnap_tpu_torch.ops.neighbors import (count_neighbors,
                                                 required_shifts, shift_table)
    from fitsnap_tpu_torch.parallel.fit import pack_batch_pos

    n = len(pos)
    s_table = tuple(map(tuple, shift_table(required_shifts(cell,
                                                           calc.cutoff))))
    k_pad = min(count_neighbors(pos, cell, n, calc.cutoff), n * len(s_table))
    pc = PackedConfig(pos=pos, cell=cell, types=np.asarray(types, np.int32),
                      natoms=n, data={})
    ph, pl, sh, sl, t, nat = (torch.from_numpy(x[0]).to(calc.device)
                              for x in pack_batch_pos([pc], n, 1,
                                                      s_table)[:6])
    disp, jidx, mask = sk.device_neighbors(ph, pl, sh, sl, nat, calc.cutoff,
                                           k_pad)
    rev, _ = sk.reverse_table(jidx, mask)
    ut, B = sol._kit["utb"](disp, jidx, mask, t, nat)
    batch = {"B": B, "ut": ut, "disp": disp, "jidx": jidx, "mask": mask,
             "rev": rev, "types": t, "elem": torch.zeros_like(t),
             "real": torch.ones_like(t, dtype=torch.bool), "nat": nat}
    e, f = sol._forward_batch_cached(sol.model, batch)
    return float(e[0]) * n, f[0].cpu().numpy()


def nn_cached_fd_check(fs):
    """Central-difference forces of the trained cached model against its
    forces on three atoms of two configs (as `nn_fd_check`)."""
    sol, calc = fs.solver, fs.calculator
    worst = []
    for group in ("Displaced_BCC", "Liquid"):
        d = [x for x in fs.data if x["Group"] == group][0]
        pos = np.asarray(d["Positions"], float)
        cell = np.asarray(d["Lattice"], float)
        types = [calc.type_mapping[t] - 1 for t in d["AtomTypes"]]
        _, f0 = nn_cached_eval(sol, calc, pos, cell, types)
        for a in (0, len(pos) // 2, len(pos) - 1):
            for c in range(3):
                pp, pm = pos.copy(), pos.copy()
                pp[a, c] += FD_H
                pm[a, c] -= FD_H
                ep, _ = nn_cached_eval(sol, calc, pp, cell, types)
                em, _ = nn_cached_eval(sol, calc, pm, cell, types)
                worst.append(abs(-(ep - em) / (2 * FD_H) - f0[a, c]))
    err = float(np.max(worst))
    print(f"nn cached FD forces (h={FD_H}): max error {err:.3e}, mean "
          f"{float(np.mean(worst)):.3e} (bar {FD_BAR})", flush=True)
    if not err < FD_BAR:
        raise AssertionError(f"NN cached FD forces miss the bar: {err:.3e}")
    return {"fd_max_err": err, "fd_mean_err": float(np.mean(worst)),
            "fd_bar": FD_BAR}


def custom_batch(sol, n=4):
    """A minibatch of the first n configs of the pairwise mode's largest
    bucket, with the trained model's g_desc = dE/d(descriptor) and e_env,
    K15V's inputs as in training."""
    import torch
    from fitsnap_tpu_torch.kernels import custom_kernels as ck

    bi = int(np.argmax([np.prod(b["shape"]) for b in sol.buckets]))
    batch = sol._gather(sol.buckets[bi],
                        np.arange(min(n, len(sol.buckets[bi]["groups"]))))
    sec = sol._custom
    disp, mask = batch["disp"], batch["mask"]
    N, A, K, _ = disp.shape
    D = sec.num_radial + sec.num_3body
    desc, fc = ck.pair_desc(disp, mask, sec.cutoff, sec.num_radial,
                            sec.num_3body)
    x = ((desc - sol.mean) / sol.std).reshape(-1, D).requires_grad_(True)
    elem = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
    e_pair = sol.model(x, elem).reshape(N, A, K)
    dedx, = torch.autograd.grad((e_pair * fc).sum(), x)
    g_desc = (dedx / sol.std).reshape(N, A, K, D).contiguous()
    e_env = (e_pair * mask.to(e_pair.dtype)).detach().contiguous()
    return batch, g_desc, e_env


def custom_kernel_checks(fs):
    """K15, K15V and K15T against their plain versions on a minibatch of 4
    at the pairwise mode's largest bucket, and the loss gradient through
    PairDescForce against plain double autograd through the plain
    descriptors."""
    import torch
    from fitsnap_tpu_torch.kernels import custom_kernels as ck
    from fitsnap_tpu_torch.kernels import nn_kernels as nk
    from fitsnap_tpu_torch.ops import custom_desc as ops

    sol = fs.solver
    sec = sol._custom
    shape = (sec.cutoff, sec.num_radial, sec.num_3body)
    R, M = sec.num_radial, sec.num_3body
    batch, g_desc, e_env = custom_batch(sol)
    disp, mask, jidx = batch["disp"], batch["mask"], batch["jidx"]
    N, A, K, _ = disp.shape
    live = mask.sum(-1).to(torch.float64)
    terms = float((live * live).sum())          # (j, k) pairs, diagonal in
    pairs = int(mask.sum())
    slots = N * A * K
    print(f"custom kernel inputs: N={N} A={A} K={K} live pairs={pairs} "
          f"(j, k) terms={terms:.0f} x M={M} float64", flush=True)
    gF = ((nk.nn_pair_gather(ck.pair_desc_vjp(g_desc, e_env, disp, mask,
                                               *shape), batch["rev"])
           - batch["f_target"])
          * batch["real"][..., None].to(torch.float64)).contiguous()
    in_bytes = slots * (3 * 8 + 1)              # disp, mask
    calls = {
        "pair_desc": ((disp, mask), lambda d, m: ck.pair_desc(d, m, *shape),
                      lambda d, m: ck.pair_desc_plain(d, m, *shape),
                      in_bytes + slots * (R + M + 1) * 8),
        "pair_desc_vjp": (
            (g_desc, e_env, disp, mask),
            lambda g, e, d, m: (ck.pair_desc_vjp(g, e, d, m, *shape),),
            lambda g, e, d, m: (ck.pair_desc_vjp_plain(g, e, d, m, *shape),),
            in_bytes + slots * (R + M + 1 + 3) * 8),
        "pair_desc_jvp": (
            (gF, disp, mask, jidx),
            lambda f, d, m, j: ck.pair_desc_jvp(f, d, m, *shape, jidx=j),
            lambda f, d, m, j: ck.pair_desc_jvp_plain(f, d, m, *shape,
                                                      jidx=j),
            in_bytes + gF.numel() * 8 + slots * 4
            + slots * (R + M + 1) * 8),
    }
    rows = []
    for name, (args, kernel, plain, nbytes) in calls.items():
        out, ref = kernel(*args), plain(*args)
        flops = terms * M * GAUSS_OPS[name] + pairs * R * (EXP_OPS + 8)
        record(rows, name, list(out), list(ref),
               (rotating(kernel, args), 20), timed(rotating(plain, args), 5),
               nbytes, flops, None)
        rows[-1]["device_ms_l2"] = device_time(lambda: kernel(*args), 20)

    # the parameter gradient of the training loss: PairDescForce (K15V and
    # the gather, backward K15T) against double autograd through the plain
    # descriptors
    leaves = list(sol.model.parameters())

    def plain_forward(model, b, train=False):
        d = b["disp"].clone().requires_grad_(True)
        desc = ops.pair_descriptors(d, b["mask"], *shape)
        x = ((desc - sol.mean) / sol.std).reshape(-1, R + M)
        elem = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
        e = (model(x, elem).reshape(N, A, K)
             * ops.envelope(d, b["mask"], sec.cutoff)).sum((1, 2))
        g, = torch.autograd.grad(e.sum(), d, create_graph=True)
        nat = torch.clamp(b["nat"], min=1).to(e.dtype)
        return e / nat, nk.nn_pair_gather_plain(g, b["rev"])

    def grads():
        return torch.autograd.grad(sol._loss(sol.model, batch, train=True),
                                   leaves)

    out = grads()
    sol._forward_pairwise = plain_forward
    try:
        ref = grads()
    finally:
        del sol._forward_pairwise
    _, grad_err = rel_err(out, ref)
    print(f"custom loss gradient through PairDescForce vs plain double "
          f"autograd: {grad_err:.3e} (limit {GRAD_RTOL})", flush=True)
    if not grad_err <= GRAD_RTOL:
        raise AssertionError(f"pairwise loss gradient through PairDescForce "
                             f"differs from the plain one: {grad_err:.3e}")
    return rows, {"grad_rel_err": grad_err, "live_pairs": pairs,
                  "pair_terms": terms}


def custom_lists(calc, pos, cell):
    """Host neighbor lists of one config and its reverse table."""
    from fitsnap_tpu_torch.ops.neighbors import (host_neighbors,
                                                 reverse_neighbors)

    n = len(pos)
    disp, jidx, mask, _ = host_neighbors(pos, cell, n, calc.cutoff)
    return disp, jidx, mask, reverse_neighbors(jidx, mask, n)


def custom_eval(sol, calc, pos, cell, types):
    """Energy and forces of one config under the pairwise model: host lists,
    then K15, the MLP, K15V and the gather on the card."""
    import torch

    n = len(pos)
    disp, jidx, mask, rev = custom_lists(calc, pos, cell)

    def put(x):
        return torch.as_tensor(x, device=sol.device)[None]

    batch = {"disp": put(disp), "jidx": put(jidx), "mask": put(mask),
             "rev": put(rev),
             "types": torch.zeros((1, n), dtype=torch.int32,
                                  device=sol.device),
             "nat": torch.tensor([n], device=sol.device)}
    e, f = sol._forward_pairwise(sol.model, batch)
    return float(e[0]) * n, f[0].cpu().numpy()


def custom_fd_check(fs):
    """Central-difference forces of the trained pairwise model against its
    forces on three atoms of two configs (as `nn_fd_check`)."""
    sol, calc = fs.solver, fs.calculator
    worst = []
    for group in ("Displaced_BCC", "Liquid"):
        d = [x for x in fs.data if x["Group"] == group][0]
        pos = np.asarray(d["Positions"], float)
        cell = np.asarray(d["Lattice"], float)
        types = [calc.type_mapping[t] - 1 for t in d["AtomTypes"]]
        _, f0 = custom_eval(sol, calc, pos, cell, types)
        for a in (0, len(pos) // 2, len(pos) - 1):
            for c in range(3):
                pp, pm = pos.copy(), pos.copy()
                pp[a, c] += FD_H
                pm[a, c] -= FD_H
                ep, _ = custom_eval(sol, calc, pp, cell, types)
                em, _ = custom_eval(sol, calc, pm, cell, types)
                worst.append(abs(-(ep - em) / (2 * FD_H) - f0[a, c]))
    err = float(np.max(worst))
    print(f"custom FD forces (h={FD_H}): max error {err:.3e}, mean "
          f"{float(np.mean(worst)):.3e} (bar {FD_BAR})", flush=True)
    if not err < FD_BAR:
        raise AssertionError(f"pairwise FD forces miss the bar: {err:.3e}")
    return {"fd_max_err": err, "fd_mean_err": float(np.mean(worst)),
            "fd_bar": FD_BAR}


def custom_export_check(fs):
    """The written .pt's per-atom energies and dE/drij on one config (a
    displaced 54-atom bcc cell) against the trained model's."""
    import torch
    from fitsnap_tpu_torch.kernels import custom_kernels as ck

    sol, calc = fs.solver, fs.calculator
    sec = sol._custom
    d = [x for x in fs.data if x["Group"] == "Displaced_BCC"][0]
    pos = np.asarray(d["Positions"], float)
    n = len(pos)
    disp, jidx, mask, _ = custom_lists(calc, pos,
                                       np.asarray(d["Lattice"], float))
    module = torch.load("Ta_custom.pt", weights_only=False)
    ii, _ = np.nonzero(mask)
    rij = np.ascontiguousarray(disp[mask], np.float64)
    beta, energy = np.zeros_like(rij), np.zeros(n)
    jj = jidx[mask].astype(np.int64)
    module(np.zeros(n, np.int32), None, beta, energy, rij,
           ii.astype(np.int64), jj, ii.astype(np.int64), jj)
    dt = torch.as_tensor(disp, device=sol.device).requires_grad_(True)
    mt = torch.as_tensor(mask, device=sol.device)
    desc, fc = ck.pair_desc_plain(dt, mt, sec.cutoff, sec.num_radial,
                                  sec.num_3body)
    x = ((desc - sol.mean) / sol.std).reshape(-1, desc.shape[-1])
    e_pair = sol.model(x, torch.zeros(x.shape[0], dtype=torch.int32,
                                      device=x.device)).reshape(mask.shape)
    atoms = (e_pair * fc).sum(1)
    g, = torch.autograd.grad(atoms.sum(), dt)
    atoms = atoms.detach().cpu().numpy()
    g = g.cpu().numpy()[mask]
    err = max(np.abs(energy - atoms).max() / np.abs(atoms).max(),
              np.abs(beta - g).max() / np.abs(g).max())
    print(f"custom exported .pt vs the model: {err:.3e} (limit "
          f"{PAIR_PT_RTOL})", flush=True)
    if not err <= PAIR_PT_RTOL:
        raise AssertionError(f"the exported pairwise .pt disagrees: "
                             f"{err:.3e}")
    return {"pt_rel_err": float(err)}


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
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            kernels = []
            for kind in ("snap", "ace"):
                t0 = time.time()
                ini, fs0, data, a_plain, beta, t_plain = make_dataset(
                    tmp, args.seed, "cuda", kind)
                print(f"data ({kind}): {len(data)} configs, A "
                      f"{a_plain.shape}, plain path on the card "
                      f"{t_plain:.2f} s, set-up {time.time() - t0:.2f} s",
                      flush=True)
                kernels += (kernel_checks(fs0.calculator, data)
                            if kind == "snap" else
                            ace_kernel_checks(fs0.calculator, data, args.seed))
                del fs0, data
                torch.cuda.empty_cache()
                fs, *fitsnap = main_path(ini, a_plain, beta, "cuda", kind)
                streamed = streamed_path(fs, a_plain, beta, args.seed,
                                         "cuda", kind)
                paths[FITSNAP_PATH[kind]] = fitsnap
                paths[STREAM_PATH[kind]] = streamed
                del fs, a_plain
                torch.cuda.empty_cache()
            # quadratic SNAP and chemflag: kernels, FitSnap, then the
            # streamed fit
            for kind in ("quadratic", "inp"):
                t0 = time.time()
                ini, fs0, data, a_plain, beta, t_plain = make_dataset(
                    tmp, args.seed, "cuda", kind)
                print(f"data ({kind}): {len(data)} configs, A "
                      f"{a_plain.shape}, plain path on the card "
                      f"{t_plain:.2f} s, set-up {time.time() - t0:.2f} s",
                      flush=True)
                kernels += flag_kernel_checks(fs0.calculator, data, kind,
                                              args.seed)
                del fs0, data
                torch.cuda.empty_cache()
                fs, *fitsnap = main_path(ini, a_plain, beta, "cuda", kind)
                paths[FITSNAP_PATH[kind]] = fitsnap
                paths[STREAM_PATH[kind]] = streamed_path(
                    fs, a_plain, beta, args.seed, "cuda", kind)
                del fs, a_plain
                torch.cuda.empty_cache()
            # the NN fit on the Ta set of phase 2
            fs, counts, times, checks = nn_path(tmp, "cuda")
            rows, grad = nn_kernel_checks(fs)
            kernels += rows
            checks.update(grad, **nn_fd_check(fs), **nn_export_check(fs))
            checks.update(nn_epoch_profile(fs, times["epoch_mean_rest"]))
            paths["nn_fitsnap"] = (counts, times, checks)
            del fs
            torch.cuda.empty_cache()
            # the NN fit in the cached mode on the same set
            fs, counts, times, checks = nn_path(tmp, "cuda", "cached")
            rows, grad = nn_cached_kernel_checks(fs)
            kernels += rows
            checks.update(grad, **nn_cross_mode_check(fs),
                          **nn_cached_fd_check(fs))
            checks.update(nn_epoch_profile(fs, times["epoch_mean_rest"]))
            paths["nn_cached_fitsnap"] = (counts, times, checks)
            del fs
            torch.cuda.empty_cache()
            # the custom pairwise NN on the same set
            fs, counts, times, checks = nn_path(tmp, "cuda", "custom")
            rows, grad = custom_kernel_checks(fs)
            kernels += rows
            checks.update(grad, **custom_fd_check(fs),
                          **custom_export_check(fs))
            checks.update(nn_epoch_profile(fs, times["epoch_mean_rest"]))
            paths["custom_fitsnap"] = (counts, times, checks)
            del fs
            torch.cuda.empty_cache()
        finally:
            os.chdir(cwd)
    seconds = ("pack", "upload", "first_pass", "steady_pass", "solve",
               "refine", "eval")
    for path, (_, times, checks) in paths.items():
        print(f"{path} path timings: " + " ".join(
            f"{k}={v:.4f}" + ("s" if k in seconds or "fitsnap" in path
                              else "") for k, v in times.items()),
            flush=True)
        print(f"{path} path checks: " + json.dumps(checks), flush=True)
    for row in kernels:
        by_path = {path: counts[row["kernel"]]
                   for path, (counts, _, _) in paths.items()}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
