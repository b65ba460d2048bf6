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
   K5 the whole ZBL reference, `zbl_eav`, energy, forces and virial in one
   launch, against the plain composition (the per-slot gradient, then K4's
   plain scatter at width 1), twice bit for bit, its digest printed; K5
   also in its ref_eav mode with seeded charges and unit spins on that
   chunk: coul/cut, the spin term and zbl + coul/cut + spin, a row each;
   K8 and K8r on that chunk's positions batch), failing above 1e-11
   relative error (K8's mask and jidx and K8r's table must be equal); kernel,
   plain and library-call times with CUDA events, the kernel's device time
   (and K3's, K4's, K7's and K14's library call's) from a torch.profiler
   trace (events between launches also count the host's launch overhead,
   which exceeds the small kernels' run time), and
   the least time the card could take (bytes over 3.35 TB/s, float64
   operations over 67 T/s, the larger; K8r's by its bytes alone; K8r
   also beside `torch.sort(stable=True)` of the masked destinations, the
   order alone; K8's operations those of a binned search: each real
   candidate binned, the candidates of the 27 bins around each real atom);
   K8 also past the shared-memory cap it had before its binned search: 2
   jittered 8 x 8 x 8 bcc cells (1,024 atoms, S = 27; K8's mask and jidx
   equal, disp within 1e-12); at both sizes K8's split launch shape (a
   bin pass, then the select pass; the wrapper takes it above
   `K8_FUSED_ATOMS` atom slots) forced, held to the plain version alike,
   with a row of its own and the two shapes timed in turn;
4. FitSnap path: launch counts set to 0, then FitSnap(device="cuda") ->
   scrape_configs -> process_configs -> perform_fit -> write_output, the
   counts read just after.  It fails unless K1-K5 launched, K4 once a
   chunk (as many launches as the reference's K5: the reference no longer
   calls K4), the A matrix
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
   latter's rows, and K8r on the latter's host lists, measured as in
   phase 3; K13 also past its old limits on the Ta chunk (a plan of lmax
   8: ranks 1-4, 171 A-slots; the Ta_PACE plan in the three other
   convention pairs: radial pace_mx / v0_t1 / pace_x with Ylm std / racah
   / 4pi; the Ta_PACE plan with spline radials, delta 0.001, as the
   InP-shaped plan on its chunk), twice bit for bit with its digests
   printed, and K4 at the ACE width (the Ta_PACE chunk's 68 label
   columns, one type block);
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
   streamed one (K4 once a chunk, as in phase 4);
9. quadratic SNAP data: the same configs with `synthetic.quadratic_settings`
   (twojmax 8, quadraticflag: 55 + 1,540 descriptor columns, 1,596
   coefficients), truths from the plain path; and InP-shaped chemflag data:
   `synthetic.inp_configs` (200 zincblende In/P cells of 8, 64 and 216
   atoms in five groups) with `synthetic.inp_settings` (two elements,
   twojmax 6, wselfallflag, bnormflag, bzeroflag 1, ESHIFT, ZBL 4.0-4.2;
   480 columns), truths from the plain path;
10. quadratic and chemflag kernels, measured as in phase 3: at the quadratic
   model on the first Compressed_BCC config (the main path's chunk there:
   1 x 128 atoms x 64 slots) K1 and K2 at twojmax 8, K3 in its W
   tiles, K6q (quad_chain) and K4 at width 1,595; at the InP model on the
   main path's first Displaced_ZB64 chunk the chemflag modes of K1, K2 and
   K3 (utot in two element channels, four channel-pair z-lists, W tiles
   of the channel-resolved y-list, one pass per channel) and K4 at width
   240, K5 and K9 in its element-channel mode (the chemflag PAS prep's
   kernel, phase 18); at both, K7 on that chunk's rows with seeded truths
   and weights (width 1,596 with one constant column; 480 without), direct
   and residual;
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
11b. SNAP with the reference `hybrid/overlay zero zbl 4.0 4.8 coul/cut 5.0
   spin/exchange/biquadratic 4.5` (`synthetic.fe_settings`) on a seeded
   Fe-shaped set (`synthetic.fe_configs`: 60 bcc cells of 2, 16 and 54
   atoms whose JSON carries Spins and Charges), truths A_plain beta_true
   plus that reference: the FitSnap path as phase 4 (K1-K5 launched, K5 in
   its ref_eav mode; A equal to the plain path's to 1e-10, beta_true
   recovered); no streamed fit, which passes the reference no charges;
12. NN path (precompute mode), on the Ta set of phase 2 with
   `synthetic.nn_settings` (nonlinear 1, [PYTORCH] layer_sizes num_desc 64
   64 1, batch size 4, 10 epochs): launch counts set to 0, then
   FitSnap(device="cuda") -> scrape -> process -> perform_fit ->
   write_output, the counts read just after; it fails unless K1-K3, K5,
   K12 and K12T launched, K4 did not (its one caller there was the
   reference), the last epoch's train loss is below the first's and
   the `.pt`, `.mliap.descriptor`, `.mod` and metrics files are written.
   Then K12 and K12T against their plain versions at the largest bucket
   with a minibatch of 4, K12 also at the smallest bucket with seeded dE/dB
   and G on its lists (its perfect cells' forces cancel otherwise; 1e-11;
   timed on rotating copies of the inputs, more than four L2 sizes, so
   that G is read from HBM, and once more on one repeated input, which L2
   holds; K12 beside `torch.bmm` of its contraction alone, timed the same
   ways, and its contraction's own device time), the loss gradient with
   respect to every
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
   just after; it fails unless K5, K8, K8r, K2, K9, K10, K10T, K11,
   K11T and the force gather launched, K1, K3, K4 and K12's contraction
   did not,
   no bucket holds dB/dD, the last epoch's train loss is below the first's
   and the four files are written.  Then K9, K10, K10T, K11, K11T and the
   gather against their plain versions at the largest bucket with a
   minibatch of 4 (4 x 128 x 64; 1e-11; timed on rotating copies of the
   inputs, as K12; the gather beside `index_add_` of the neighbor scatter
   alone, its library call, and, printed as context, the whole gather in
   PyTorch: g.sum(2), then `index_add_`), K9, K10, K11, K11T and K10T also
   at the smallest bucket (4 x 8 x 64), K9 also at one chunk of the cached
   prep (32 configs of the largest bucket, where K9 runs in a fit), K9 and
   K10 twice bit for bit, the digests of K9's and K10's outputs, of K11's
   on a seeded grid cotangent and of K11T's on a seeded force cotangent,
   with K8's at the SNAP chunk and K12's on a seeded dE/dB and G at the NN
   minibatch (to
   compare builds bit for bit; K10's and K10T's bounds count the z entries
   the y tables reference, the least they must read, K9's the live pairs'
   values-only prologue and grid update and its B terms), the loss
   gradient through
   `NnCachedForce` against autograd through the plain versions (1e-10), the trained model's energies and forces on that
   minibatch against the precompute path's (K1-K3's dB/dD, then K12;
   1e-9), central-difference forces (device neighbor lists, K9 and the
   cached forward at each displaced position) on three atoms of two configs
   (1e-5), and a profiler split of one epoch;
14. NN path in the OTF mode, linear SNAP, on the same set with
   `nn_settings(..., dgrad_mode="otf")` and its 10 epochs: launch counts
   set to 0, then FitSnap(device="cuda") -> scrape -> process ->
   perform_fit -> write_output, the counts read just after; it fails
   unless K5, K8, K8r, K2, K9, K10, K10T, K11, K11T and the force gather
   launched (K8, K8r and K9 every step), K1, K3, K4 and K12's contraction
   did not, the solver resolved to OTF, no bucket holds dB/dD, disp or
   ut, the last epoch's train loss is below the first's and the four
   files are written.  Then the trained model's energies and forces on a
   minibatch of 4 of the largest bucket against the precompute path's
   (K1-K3's dB/dD on the lists the step builds, then K12) and the cached
   step's on those lists (1e-9), central-difference forces (each displaced
   config packed as an OTF bucket, then the OTF forward) on three atoms of
   two configs (1e-5), and a profiler split of one epoch;
15. the same with quadraticflag 1 (twojmax 6: 30 + 465 descriptors) for 3
   epochs: the kernels of phase 14, and K6q not; the forces against the
   precompute path's (K1-K3, K6q, K12);
16. chemflag in the OTF mode on the InP-shaped set of phase 9 with
   `synthetic.inp_nn_settings(..., dgrad_mode="otf")` for 3 epochs: it
   fails unless K5, K8, K8r, the chemflag modes of K1-K3, K12, K12T and
   the gather launched and K9-K11T did not; the forces against the
   precompute path's, FD forces on two 64-atom cells (a displaced and an
   antisite one), a profiler split of one epoch;
16b. nonlinear ACE (`synthetic.ace_nn_settings`: the Ta_PACE plan, 68
   labels, under the [PYTORCH] section of phase 12) on the ACE set of
   phase 6 for 4 epochs, precompute then OTF: launch counts set to 0,
   FitSnap(device="cuda") -> scrape -> process -> perform_fit ->
   write_output, the counts read just after; it fails unless K13, K14, K5,
   K12 and K12T launched (OTF: K8 and K8r too) and no SNAP kernel did,
   OTF kept no G, the train loss fell and the `.pt` and metrics were
   written.  Then the `.pt` against the model, OTF against the precompute
   path's forces on a minibatch (1e-9), central-difference forces (1e-5),
   the same fit with every kernel's plain version on the card (the loss
   curves equal to 1e-10), and a profiler split of one epoch;
17. the custom pairwise NN (calculator LAMMPSCUSTOM) on the same set with
   `synthetic.custom_settings` (31 Bessel / Gaussian 3-body pair
   descriptors at cutoff 5.0, `num_desc 64 64 1`, batch 4, 10 epochs, the
   raw energies and forces): launch counts set to 0, then
   FitSnap(device="cuda") -> scrape -> process -> perform_fit ->
   write_output, the counts read just after; it fails unless K15, K15V,
   K15T and the force gather launched, the last epoch's train loss is
   below the first's and the `.pt`, metrics and loss files are written.
   Then K15, K15V and K15T (with the gather's transpose, as in training)
   against their plain versions on the largest minibatch (4 x 128 x 64)
   and on a minibatch of the (8, 64) bucket, the set's most common (4 x 8
   x 64; 1e-11; timed on rotating copies of the inputs; K15's outputs'
   digests printed, to compare builds bit for bit), the force gather on
   that small minibatch's lists with seeded pair gradients (its cells are
   symmetric: K15V's gradients give forces that cancel to rounding), timed
   as in phase 13 with its `index_add_` and the whole gather in PyTorch,
   the loss gradient
   through `PairDescForce` against plain double autograd through the
   plain descriptors on the card (1e-10), central-difference forces (host
   lists and K15 at each displaced position) on three atoms of two configs
   (1e-5), the `.pt`'s per-atom energies and dE/drij on one config against
   the trained model's (the JAX package's 1e-7: standardization is folded
   into layer 1), and a profiler split of one epoch;
18. per-atom-scalar (PAS) fits of a seeded per-atom `Chis`
   (`synthetic.with_chis`, `synthetic.pas_settings`: `num_desc 64 64 1`,
   batch 4) through FitSnap(device="cuda") -> scrape -> process ->
   perform_fit -> write_output, launch counts set to 0 just before and
   read just after: chemflag SNAP on the InP-shaped configs of phase 9
   (the InP_JPCA2020 BISPECTRUM, 240 descriptors; 3 epochs), then linear
   SNAP on the Ta-shaped configs of phase 2 and ACE (the Ta_PACE plan, 68
   labels) on them (2 epochs each).  Each fails unless its descriptors'
   kernels launched (K9 in its element-channel mode; K9; K13 and K14) and
   no other port kernel did, its buckets keep B alone on the card (no G,
   lists or positions), the train loss fell and the `.pt` and metrics
   were written; then the `.pt`'s per-atom outputs against
   `evaluate_bucket`'s (1e-10), the same fit with every kernel's plain
   version on the card (the loss curves equal to 1e-10) and a profiler
   split of one epoch.  K9's element-channel mode also has kernel rows:
   at the InP chunk of phase 10 (7 x 64 x 96) and at one chunk of the
   chemflag PAS prep, each held to its plain version (1e-11), twice bit
   for bit with its digest printed;
19. the host copies on the Ta-shaped set of phase 2: (a) the set written
   as extended XYZ (one file a group, floats %.17g) and fitted through
   FitSnap(device="cuda") with `scraper XYZ` and SVD, launch counts set to
   0 just before and read just after: K1-K5 must launch as on phase 4's
   path, A, b and w equal phase 4's row for row (configs matched by group
   and energy) to 1e-10 relative per column, the fit within 100 cond eps
   of phase 4's; (b) the set written as OUTCAR trees (two a group, its
   configs as ionic steps) and fitted with `scraper VASP`, counted the
   same way: A within 1e-10 of the plain path's on the same scraped dicts,
   and a second run from the vJSON cache the same A; (c) FitSnap on the
   XYZ set with each host solver that needs no sklearn: RIDGE
   (`local_solver`), ANL, BCS, OPT, MCMC (3,000 steps) and MERR (BFGS),
   BCS and MERR on the Displaced_FCC group alone (4,635 rows; MERR its
   first half: BCS forms an N x N matrix of the training rows each
   iteration, and MERR's BFGS on finite differences evaluates all rows
   some 60 times a step; the set's first groups are perfect lattices,
   whose weighted rows leave cond about 1e22), metrics written in the
   JSON style and parsed back; each solver's coefficients within 100 cond(AᵀA) eps of the same
   solver on the host with A_plain (each forms the weighted AᵀA; MCMC:
   the chain's mean within 0.1, the bar of
   tests/test_solvers.py::test_mcmc_solver_recovers_truth; BCS and MERR,
   whose fits a 5e-15 difference in A moves by order 1: their rows within
   1e-10 of A_plain's, the distance from the A_plain run printed); (d)
   `python -m fitsnap_tpu_torch <ini> --torchprof DIR` on the card on the
   Displaced_FCC group of the XYZ set, whose trace must name K1-K5's
   kernels; (e) the torch finite-difference harness
   (`tools/test_tools.TestTools`) on phase 12's precompute NN settings,
   its largest error within the bar of 1e-5.  Each scraper's and each
   solver's seconds are printed.
20. the native neighbor builder and multi-GPU on the Ta-shaped set of
   phase 2: (a) `host_neighbors` (native/neighbors.cpp, g++) against
   `host_neighbors_plain` (numpy) on every config: mask and jidx equal,
   disp within 1e-12; FitSnap's process seconds with each, in turns
   (plain, native, native, plain); K4's gather_only mode (the spatial
   rows' halo) against its plain version at the spatial config's shapes,
   within 1e-11, timed beside it and `index_add_` (its `kernels` row
   `pair_scatter_rows@halo`); (b) a NCCL group of one rank
   (`file://` store in a temporary directory), launch counts set to 0
   just before and read just after (path dp_nccl1): phase 5's streamed
   pass, `TpuSVD` on phase 4's rows and 2 epochs of the cached NN fit
   must equal the same code run just before without a group, bit for
   bit (AtA, Atb, nrows; coefficients; loss curve and parameters);
   (c) 2 spawned processes in a gloo group, both on cuda:0, their counts
   set to 0 at their start and summed (path dp_gloo2): the streamed fit
   with each rank on its half of every chunk (AtA and Atb within 1e-12
   relative of (b), nrows equal, each rank's launches of K1-K5, K7, K8
   and K8r equal to (b)'s: one a chunk), `TpuSVD` (within the larger of
   1e-10 and 100 cond eps of (b), cond that of the equilibrated normal
   matrix: the split reorders AtA's sums), the NN loss curve (within
   1e-10 relative of (b)'s) and the spatial rows of the set's largest
   config split two ways (within 1e-12 relative of one process's).
21. (run after phase 11b, before 12: after the NN phases' epoch profiles
   the profiler's later traces of this process hold no device time)
   twojmax 13-16 (`LARGE_TJ`),
   past K1's window shape and K3's whole y rows, on 28 Ta-shaped configs of
   the set's shapes (`LARGE_COUNTS`; at twojmax 16 without the cells of 100
   and 128 atoms, `LARGE_DROP`, and A_plain formed a config a chunk: the
   plain z-lists take 153 MB an atom there), the SNAP plan of each twojmax
   built once and shared by its paths (the planning seconds printed apart):
   K1-K3 against their plain versions at twojmax 13, 14 and 16 on the first
   2, 4 and 1 Displaced_BCC configs (K1 in its recursion shape, K3 in its
   level shape; rows named by their entry points, `pair_u_recur` and
   `dbdd_level`, whose launches the FitSnap and streamed paths at 14 and
   16 must show), K3's slab shape forced there too and the two timed in
   turns, K9, K10, K11, K11T (its tiles over two blocks at 16) and K10T at
   14 and 16 on those chunks' lists, as phase 13's rows, with a seeded
   dE/dB and force cotangent, K1 in its window and its recursion shape
   (both forced) at twojmax 6, 8, 10, 11 and 12 on the twojmax-14 chunk's
   inputs, timed in turns, and the chemflag modes of K1-K3 at twojmax 12
   on phase 9's first Displaced_ZB64 chunk; the FitSnap path (as phase 4:
   A against A_plain to 1e-10 per column, beta_true within 100 cond eps)
   at 14 and 16, the
   streamed fit (as phase 5) at 14; the NN fits at 16 (`nn_settings` on the
   cells of 2 and 4 atoms, `LARGE_NN_GROUPS`, 2 epochs): `dgrad_mode =
   auto` (it must resolve to the cached mode) and OTF, each with its
   launches, no dB/dD stored (OTF: nor disp or ut) and its loss curve
   against the same fit with every kernel's plain version on the card
   (1e-10).  Each path prints its peak device memory
   (`torch.cuda.max_memory_allocated`).  K2's library call at 13, 14 and
   16 is `torch.bmm` over the dense term tables of the phase's own plans
   (kept as they are built), timed where they fit half the free memory,
   their bytes printed either way, and where they do not, timed beside K2
   on the chunk's first atoms at which they fit (a row of its own,
   `zlist@tj14_<n>atoms`).  The streamed pass at 14 is profiled with K3
   in its level and its slab shape in turns.
22. (run after phase 3 and phase 5) the float32 streamed fit: K8, K1 (its
   window shape), K2, K3 (whole rows, its float32 product on the CUDA
   cores), K4, K5 (`zbl_eav`) and K7 in their float32 instantiations
   against their plain float32 versions on phase 3's chunk, its positions
   packed at float32 (hi/lo) and every later input made from them
   (1e-5 relative; K8's mask and jidx equal and its disp within 2 ulp,
   K8r's table equal; every output float32, K7's AtA and Atb float64 and
   its residual A^T r float32; bounds at 4 bytes a value and the FP32
   CUDA-core rate); then phase 5's streamed fit on the same set packed at
   float32 (launch counts set to 0 just before and read after the refined
   fit and the evaluation: every kernel in its float32 instantiation, none
   at float64), nrows equal to phase 5's, AtA and Atb within 1e-5 of phase
   5's float64 ones, the refined float32 fit within 100 cond(w A) 2^-23
   and 1e-3 of beta_true, the MAE sums within 1e-4 of phase 5's at
   beta_true spread 10%; the device ms of a steady pass at float64 and
   float32 in turns (64, 32, 32, 64) and the bytes of a chunk's disp and
   dB/dD at each type.
23. (run after phase 14) the float32 NN fits: phase 13's cached fit and
   phase 14's OTF fit with `--dtype float32` (the same set, settings,
   epochs and seeded initial parameters, drawn at float64 and rounded):
   launch counts set to 0, FitSnap(device="cuda") -> scrape -> process ->
   perform_fit -> write_output, the counts read just after.  Each fails
   unless the float32 instantiations of K2, K5 (`zbl_eav`), K8, K9, K10,
   K10T, K11, K11T and the gather launched and none of their float64 ones,
   K8r launched and K1, K3, K4 and K12 did not; every float tensor of the
   buckets, the standardization and the model is float32 (the buckets'
   bytes by type printed beside the float64 fit's); the train loss fell;
   every epoch's train loss is within 1e-3 relative of phase 13's or 14's;
   the trained model's energies and forces on a minibatch of 4 of the
   largest bucket are within 1e-4 of the float64 path's on the same
   configs at its parameters widened; the `.pt` and metrics are written.
   Then K9, K10, K10T, K11, K11T and the gather at float32 against their
   plain float32 versions on minibatches of 4 x 128 x 64 and 4 x 8 x 64 of
   the cached fit (1e-4, twice bit for bit, digests printed; bounds at 4
   bytes a value and the FP32 CUDA-core rate), each timed against its
   float64 instance on phase 13's same configs in turns (the device ms of
   one profiler trace of both); and one profiled epoch of each mode at
   each type in turns (its device ms).  The phase's seconds are printed.

Each NN phase's profiler split prints the port's kernels' launches in the
profiled epoch beside their device ms (the cached epoch's K11T and gather
among them).  Rows of kernels whose work is f64
arithmetic outside the tensor cores (K9-K11T, K15-K15T) also carry
`bound_ms_fp64_vector`, their bound at the FP64 vector rate.

The line before the last is the kernel table as JSON (launches per path,
each path's counts set to 0 just before it and read just after); the last
line is {"ok": true, "device": {...}}.  Without a CUDA device, or run where
the package is missing, it exits non-zero and prints no result.
"""

import argparse
import contextlib
import dataclasses
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
FP64_VECTOR_FLOPS = 34e12   # H100 SXM FP64 off the tensor cores (data sheet)
FP32_FLOPS = 67e12          # H100 SXM FP32 off the tensor cores (data sheet)
EXP_OPS = 20                # operations of one f64 exp (a software routine)
KERNEL_RTOL = 1e-11         # kernel vs plain, relative to the largest |value|
A_RTOL = 1e-10              # main-path A vs plain A, per column
RESID_RTOL = 1e-10          # weighted fit residual, relative to |w b|
NORMAL_RTOL = 1e-10         # streamed AtA / Atb vs the host's from A_plain
MAE_RTOL = 1e-10            # streamed MAE sums vs the host's
EPS64 = 2.220446049250313e-16
# phase 22, the float32 streamed fit: each float32 kernel against its plain
# float32 version (relative to the largest |value|; float32 sums in other
# orders), K8's disp in ulps, the normal equations against phase 5's
# float64 ones, the MAE sums against phase 5's at the same coefficients
KERNEL_RTOL32 = 1e-5
K8_ULPS32 = 2
NORMAL_RTOL32 = 1e-5
MAE_RTOL32 = 1e-4
EPS32 = 2.0 ** -23
BETA_RTOL32 = 1e-3          # the float32 fit from beta_true, beside the cond
                            # bound (measured 1.36e-4)
# coefficients 10% off beta_true (seeded), where phase 22 compares the MAE
# sums: there the residuals stand far above float32 rounding, which the
# sums at the fit's own coefficients (truths A beta_true) are made of
MAE_SPREAD = 0.1

SOURCES = {
    "pair_u_duals": ("fitsnap_tpu_torch/kernels/csrc/pair_u_duals.cu",
                     "fitsnap_tpu/ops/snap.py:667"),
    "zlist": ("fitsnap_tpu_torch/kernels/csrc/zlist.cu",
              "fitsnap_tpu/ops/snap.py:1061"),
    "dbdd": ("fitsnap_tpu_torch/kernels/csrc/dbdd.cu",
             "fitsnap_tpu/ops/snap.py:823"),
    # the shapes of K1 and K3 past twojmax 12, by entry point
    "pair_u_recur": ("fitsnap_tpu_torch/kernels/csrc/pair_u_duals.cu",
                     "fitsnap_tpu/ops/snap.py:667"),
    "dbdd_level": ("fitsnap_tpu_torch/kernels/csrc/dbdd.cu",
                   "fitsnap_tpu/ops/snap.py:823"),
    "dbdd_slab": ("fitsnap_tpu_torch/kernels/csrc/dbdd.cu",
                  "fitsnap_tpu/ops/snap.py:823"),
    "pair_scatter_rows": ("fitsnap_tpu_torch/kernels/csrc/pair_scatter.cu",
                          "fitsnap_tpu/calculators/snap.py:326"),
    "zbl_eav": ("fitsnap_tpu_torch/kernels/csrc/zbl_pair.cu",
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
    "nn_ut_b_chem": ("fitsnap_tpu_torch/kernels/csrc/nn_grid.cu",
                     "fitsnap_tpu/ops/snap.py:385"),
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
# the float32 instantiations of the streamed fit's kernels (phase 22),
# launches counted apart as "<name>_f32"
F32_KERNELS = ("pair_u_duals", "zlist", "dbdd", "pair_scatter_rows",
               "zbl_eav", "normal_contrib", "device_neighbors")
# the float32 instantiations of the NN solver's cached and OTF kernels
# (phase 23)
F32_NN_KERNELS = ("nn_ut_b", "nn_dedu_vg", "nn_dedu_vg_t", "nn_pair_force",
                  "nn_pair_force_t", "nn_pair_gather")
SOURCES.update({k + "_f32": SOURCES[k] for k in F32_KERNELS
                + F32_NN_KERNELS})
FITSNAP_KERNELS = ("pair_u_duals", "zlist", "dbdd", "pair_scatter_rows",
                   "zbl_eav")
STREAM_KERNELS = ("normal_contrib", "device_neighbors", "reverse_table")
# the entry points of K1's and K3's shapes past twojmax 12
LARGE_SHAPES = ("pair_u_recur", "dbdd_level")
ACE_KERNELS = ("ace_pair_basis", "ace_b_dbdd", "pair_scatter_rows",
               "zbl_eav")
QUAD_KERNELS = FITSNAP_KERNELS + ("quad_chain",)
CHEM_KERNELS = ("pair_u_duals_chem", "zlist_chem", "dbdd_chem",
                "pair_scatter_rows", "zbl_eav")
NN_KERNELS = ("pair_u_duals", "zlist", "dbdd", "zbl_eav", "nn_force",
              "nn_force_t")
NN_CACHED_KERNELS = ("zbl_eav", "device_neighbors", "reverse_table", "zlist",
                     "nn_ut_b", "nn_dedu_vg", "nn_dedu_vg_t", "nn_pair_force",
                     "nn_pair_force_t", "nn_pair_gather")
# kernels the cached mode must not launch (K1, K3 and K12's contraction;
# K4 is checked by `check_launched`)
NN_CACHED_ABSENT = ("pair_u_duals", "dbdd", "nn_force")
# the OTF mode's routes: linear SNAP and quadraticflag rebuild the cached
# step's inputs every step (K8, K8r, K9), chemflag forms B and dB/dD with
# K1-K3's chemflag modes and takes the forces through K12
NN_OTF_CHEM_KERNELS = ("zbl_eav", "device_neighbors", "reverse_table",
                       "pair_u_duals_chem", "zlist_chem", "dbdd_chem",
                       "nn_force", "nn_force_t", "nn_pair_gather")
# nonlinear ACE: K13 and K14 for B and dB/dD (each minibatch in OTF, after
# K8 and K8r), K12 / K12T, K5 in the prep
ACE_NN_KERNELS = ("ace_pair_basis", "ace_b_dbdd", "zbl_eav", "nn_force",
                  "nn_force_t")
# phase 23: the float32 cached and OTF fits launch every kernel of phases
# 13 and 14 in its float32 instantiation (K8r reads integers only) and
# none at float64, nor K1, K3, K4 or K12
NN_F32_KERNELS = tuple(k + "_f32" for k in ("zbl_eav", "device_neighbors",
                                            "zlist") + F32_NN_KERNELS) \
    + ("reverse_table",)
NN_F32_ABSENT = ("zbl_eav", "device_neighbors", "zlist") + F32_NN_KERNELS \
    + ("pair_u_duals", "pair_u_duals_f32", "dbdd", "dbdd_f32",
       "pair_scatter_rows_f32", "nn_force", "nn_force_t")
NN_F32_PATH = {"cached": "nn_cached_f32_fitsnap",
               "otf": "nn_otf_f32_fitsnap"}
KERNEL_RTOL_NN32 = 1e-4     # phase 23's kernels vs their float32 twins
LOSS_RTOL32 = 1e-3          # phase 23's loss curves vs phases 13 and 14
MODEL_RTOL32 = 1e-4         # its trained model vs the float64 path
NN_PATH = {"precompute": "nn_fitsnap", "cached": "nn_cached_fitsnap",
           "custom": "custom_fitsnap", "otf": "nn_otf_fitsnap",
           "otf_quadratic": "nn_otf_quadratic_fitsnap",
           "otf_chem": "nn_otf_chem_fitsnap", "ace": "ace_nn_fitsnap",
           "ace_otf": "ace_nn_otf_fitsnap", "pas_chem": "pas_chem_fitsnap",
           "pas": "pas_fitsnap", "pas_ace": "pas_ace_fitsnap"}
# the SNAP kernels, which no nonlinear ACE fit may launch
SNAP_ONLY = ("pair_u_duals", "zlist", "dbdd", "quad_chain", "nn_ut_b",
             "nn_dedu_vg", "nn_dedu_vg_t", "nn_pair_force", "nn_pair_force_t",
             "pair_u_duals_chem", "zlist_chem", "dbdd_chem")
# the kernels each mode must not launch
NN_ABSENT = {"cached": NN_CACHED_ABSENT, "otf": NN_CACHED_ABSENT,
             "otf_quadratic": NN_CACHED_ABSENT + ("quad_chain",),
             "otf_chem": ("nn_ut_b", "nn_dedu_vg", "nn_dedu_vg_t",
                          "nn_pair_force", "nn_pair_force_t"),
             "ace": SNAP_ONLY + ("device_neighbors", "reverse_table"),
             "ace_otf": SNAP_ONLY}
# epochs of the OTF, ACE and PAS phases (the others: `nn_settings`' 10)
NN_EPOCHS = {"otf_quadratic": 3, "otf_chem": 3, "ace": 4, "ace_otf": 4,
             "pas_chem": 3, "pas": 2, "pas_ace": 2}
# PAS (per-atom scalars, `synthetic.pas_settings`): each phase's data set
# (a copy of a set above with the seeded `Chis` of `synthetic.with_chis`),
# its base sections and its output name; PAS launches its descriptors'
# kernels in the prep and no kernel in training
PAS_SETS = {"pas_chem": ("INP_PAS_JSON", "inp_settings", "InP_pas"),
            "pas": ("PAS_JSON", "ta_settings", "Ta_pas"),
            "pas_ace": ("PAS_JSON", "ace_settings", "Ta_ace_pas")}
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
                "nn_otf_fitsnap": NN_CACHED_KERNELS,
                "nn_otf_quadratic_fitsnap": NN_CACHED_KERNELS,
                "nn_otf_chem_fitsnap": NN_OTF_CHEM_KERNELS,
                "ace_nn_fitsnap": ACE_NN_KERNELS,
                "ace_nn_otf_fitsnap": ACE_NN_KERNELS + ("device_neighbors",
                                                        "reverse_table"),
                "custom_fitsnap": CUSTOM_KERNELS,
                "fe_fitsnap": FITSNAP_KERNELS,
                # K9 in its element-channel mode alone (nn_path counts K9's
                # launches there under "nn_ut_b_chem": its plan has two)
                "pas_chem_fitsnap": ("nn_ut_b_chem",),
                "pas_fitsnap": ("nn_ut_b",),
                "pas_ace_fitsnap": ("ace_pair_basis", "ace_b_dbdd"),
                "xyz_fitsnap": FITSNAP_KERNELS,
                "vasp_fitsnap": FITSNAP_KERNELS,
                # phase 20: the streamed fit and the cached NN fit (and,
                # in the gloo world, the spatial rows, K4 and K8r)
                "dp_nccl1": FITSNAP_KERNELS + STREAM_KERNELS
                + NN_CACHED_KERNELS,
                "dp_gloo2": FITSNAP_KERNELS + STREAM_KERNELS
                + NN_CACHED_KERNELS,
                # phase 21 (K1 in its recursion shape, K3 in its level
                # shape)
                "tj14_fitsnap": FITSNAP_KERNELS + LARGE_SHAPES,
                "tj16_fitsnap": FITSNAP_KERNELS + LARGE_SHAPES,
                "tj14_streamed": FITSNAP_KERNELS + STREAM_KERNELS
                + LARGE_SHAPES,
                "tj16_nn_cached_fitsnap": NN_CACHED_KERNELS,
                "tj16_nn_otf_fitsnap": NN_CACHED_KERNELS,
                # phase 22: every kernel in its float32 instantiation (K8r
                # reads integers only)
                "streamed_f32": tuple(k + "_f32" for k in F32_KERNELS)
                + ("reverse_table",),
                "nn_cached_f32_fitsnap": NN_F32_KERNELS,
                "nn_otf_f32_fitsnap": NN_F32_KERNELS}
# paths whose K4 launches are the rows', one a reference call
ROWS_PATHS = ("fitsnap", "streamed", "ace_fitsnap", "ace_streamed",
              "quadratic_fitsnap", "quadratic_streamed", "chem_fitsnap",
              "chem_streamed", "fe_fitsnap", "xyz_fitsnap", "vasp_fitsnap",
              "tj14_fitsnap", "tj16_fitsnap", "tj14_streamed", "streamed_f32")
# the plan of K13's lmax-8 row (ranks 1-4, 171 A-slots), on the Ta chunk
LMAX8_SHAPE = dict(numtypes=1, ranks=[1, 2, 3, 4], nmax=[8, 2, 2, 1],
                   lmax=[0, 8, 3, 2], lmin=[0, 0, 0, 0], nmaxbase=8,
                   rcutfac=[4.6], lmbda=[3.0], rcinner=[0.0],
                   drcinner=[0.01], b_basis="minsub")
# K13's three non-default convention pairs (radial, ylm), on Ta_PACE
K13_CONVENTIONS = (("pace_mx", "std"), ("v0_t1", "racah"), ("pace_x", "4pi"))
# FitSnap and streamed paths of each data set
FITSNAP_PATH = {"snap": "fitsnap", "ace": "ace_fitsnap",
                "quadratic": "quadratic_fitsnap", "inp": "chem_fitsnap",
                "fe": "fe_fitsnap", "tj14": "tj14_fitsnap",
                "tj16": "tj16_fitsnap"}
STREAM_PATH = {"snap": "streamed", "ace": "ace_streamed",
               "quadratic": "quadratic_streamed", "inp": "chem_streamed",
               "tj14": "tj14_streamed"}
# the groups the streamed fit runs of each set (None: all of them)
STREAM_GROUPS = {"snap": None, "ace": None, "quadratic": ["Compressed_BCC"],
                 "inp": None, "tj14": None}
# the sets whose fits must recover beta_true (the linear SNAP ones)
BETA_KINDS = ("snap", "tj14", "tj16")
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
INP_NN_FILES = ["InP_nn.pt", "InP_nn_pot.mliap.descriptor", "InP_nn_pot.mod",
                "InP_nn_metrics.md", "loss_vs_epochs.dat"]
CUSTOM_FILES = ["Ta_custom.pt", "Ta_custom_metrics.md", "loss_vs_epochs.dat"]
ACE_NN_FILES = ["Ta_ace_nn.pt", "Ta_ace_nn_metrics.md", "loss_vs_epochs.dat"]
LOSS_RTOL = 1e-10           # NN loss curves vs the plain versions' fit
SPLINE_DELTA = 0.001        # ML-PACE's default spline bin (deltaSplineBins)
# K5's modes on the SNAP chunk: REFERENCE declarations (Z = 73; the spin
# term's Bethe-Slater parameters those of synthetic.fe_settings)
K5_SPIN = ("pair_coeff * * spin/exchange/biquadratic biquadratic 4.5 0.2827 "
           "-4.747 0.7810 0.0234 -1.0 0.6 offset yes")
K5_MODES = {
    "coul": ["pair_style coul/cut 5.0"],
    "spin": ["pair_style spin/exchange/biquadratic 4.5", K5_SPIN],
    "zbl+coul+spin": ["pair_style hybrid/overlay zero 10.0 zbl 4.0 4.8 "
                      "coul/cut 5.0 spin/exchange/biquadratic 4.5",
                      "pair_coeff * * zero", "pair_coeff * * zbl 73 73",
                      "pair_coeff * * coul/cut", K5_SPIN]}
# the pairwise set's most common bucket (205 of its 357 configs)
SMALL_BUCKET = (8, 64)
# configs of one chunk of the NN cached prep (solvers/network.py
# `_prepare_pos`, where the (A, S, A) transient does not bind)
PREP_CHUNK = 32
PAIR_PT_RTOL = 1e-7         # pairwise .pt vs the model (the JAX test's bar)
# operations of one (j, k) pair's Gaussian column in K15, K15V, K15T when
# each Gaussian costs its own exp: the exp, the square and the weighted
# sums (K15V: both legs' sums; K15T: the cosine tangent)
GAUSS_OPS = {"pair_desc": EXP_OPS + 4, "pair_desc_vjp": EXP_OPS + 10,
             "pair_desc_jvp": EXP_OPS + 8}
# The work of K15, K15V and K15T by the Gaussian recurrence
# (csrc/pair_desc.cu), as the function needs it: a pair's Gaussians depend
# only on its cosine, so each unordered live pair (s, o), s != o, needs per
# chunk of RECUR_MC columns one anchor of two exps and 4 operations (the
# square, its scaling, the ratio's exponent) and per column the two
# products of the recurrence and the weighted sums of both sides (K15: one
# FMA a side; K15V: the offset and its product with G once, three FMAs a
# side; K15T: two FMAs a side).  The diagonal's cosine is 0, its Gaussians
# a constant table: one FMA a column (K15's fc3 term, K15V's Q, K15T's
# fc3' a term).  An FMA counts 2.
RECUR_MC = 8
ANCHOR_OPS = 2 * EXP_OPS + 4
RECUR_PAIR_OPS = {"pair_desc": 2 + 2 * 2,
                  "pair_desc_vjp": 2 + 2 + 2 * 3 * 2,
                  "pair_desc_jvp": 2 + 2 * 2 * 2}
DIAG_COL_OPS = 2
# digests of kernels' outputs (to compare builds bit for bit), printed on
# one line before the kernel table
DIGESTS = {}
# phase 20: the gloo world (ranks sharing cuda:0), the epochs of its NN fits,
# its limits against the NCCL world of one rank, and a rank's time limit
DP_RANKS = 2
DP_EPOCHS = 2
DP_NORMAL_RTOL = 1e-12      # streamed and spatial AtA / Atb
DP_SVD_RTOL = 1e-10         # TpuSVD coefficients
DP_LOSS_RTOL = 1e-10        # the NN loss curve
DP_TIMEOUT = 300
DISP_ATOL = 1e-12           # native against plain neighbor displacements
# phase 21: twojmax 13-16 on the Ta-shaped configs of `LARGE_COUNTS` (28 of
# the set's shapes): the kernels at these twojmax, the FitSnap path at 14
# and 16, the streamed fit at 14, the NN fits at 16 (`LARGE_EPOCHS` each),
# K1's two shapes at twojmax 12 and the chemflag modes of K1-K3 at twojmax
# 12 on an InP chunk; the paths share one plan a twojmax (`shared_plans`)
LARGE_TJ = (13, 14, 16)
LARGE_COUNTS = {"Volume_BCC": 3, "Elastic_BCC": 5, "Elastic_FCC": 3,
                "Displaced_BCC": 8, "Displaced_FCC": 5, "Compressed_BCC": 2,
                "Liquid": 2}
# The plain versions' z-lists gather 4 doubles a z term an atom: 153 MB an
# atom at twojmax 16 (4.77M terms).  So the set of the last twojmax leaves
# out the cells of 100 and 128 atoms, its A_plain is formed a config a
# chunk, its kernel rows take one config, and its NN fits the cells of 2
# and 4 atoms (the plain fit's evaluation of 32-atom cells asked for 18 GB
# more than the card had free)
LARGE_DROP = ("Compressed_BCC", "Liquid")
LARGE_NN_GROUPS = ("Volume_BCC", "Elastic_BCC", "Elastic_FCC")
LARGE_CHUNK = {13: 2, 14: 4, 16: 1}   # configs of each kernel chunk
LARGE_EPOCHS = 2
WINDOW_TJ = 12   # K1's chemflag rows at twojmax 12 (InP's two channels)
# twojmax where K1's two shapes are timed in turns on the same inputs
SHAPE_TJ = (6, 8, 10, 11, 12)
# the section values one SNAP plan depends on (ops/snap.py make_params)
PLAN_KEYS = ("twojmax", "numtypes", "wj", "radelem", "rcutfac", "rfac0",
             "rmin0", "chemflag", "bnormflag", "bzeroflag", "wselfallflag",
             "quadraticflag", "switchflag", "switchinnerflag", "sinner",
             "dinner")
# phase 19: the host solvers that need no sklearn, with their extra
# settings (MCMC: the chain length of tests/test_solvers.py's MCMC test)
HOST_SOLVERS = {"RIDGE": {"RIDGE": {"local_solver": 1}}, "ANL": {},
                "BCS": {}, "OPT": {}, "MCMC": {"SOLVER": {"mcmc_num": 3000}},
                "MERR": {"SOLVER": {"merr_sampler": "bfgs"}}}
# BCS and MERR fit one group alone: BCS forms an N x N matrix of the
# training rows each iteration, and MERR's BFGS on finite differences
# costs some 60 evaluations of the whole set's rows a step (MERR: the
# group's first half); the set's first groups are perfect lattices, whose
# weighted rows leave cond about 1e22, so the group is Displaced_FCC (4,635
# rows)
SUBSET_GROUPS = {"BCS": {"Displaced_FCC": "1.0 0.0 100.0 1.0 1e-8"},
                 "MERR": {"Displaced_FCC": "0.5 0.0 100.0 1.0 1e-8"}}
# solvers whose fit a 5e-15 difference in A moves by 0.1-2 relative on
# Displaced_FCC (one H100): BCS picks its basis by argmax and divides by
# alpha - S where the two cancel, MERR's BFGS on finite-difference
# gradients stops at gtol 1e-3; on the card path their rows are held to
# A_plain's (A_RTOL) and their distance from the same solver on A_plain is
# printed
PATH_DEPENDENT = ("BCS", "MERR")
MCMC_MEAN_TOL = 0.1         # tests/test_solvers.py's MCMC bar (absolute)
# the kernel names of K1-K5 that a --torchprof trace of a SNAP fit must hold
TRACE_KERNELS = ("pair_u_duals_kernel", "zlist_kernel", "dbdd_kernel",
                 "scatter_rows_kernel", "ref_eav_kernel")
# the profiler's kernel name of a wrapper, where it is not <wrapper>_kernel
KERNEL_FN = {"nn_force": "nn_fpair_kernel", "zbl_eav": "ref_eav_kernel",
             "nn_pair_gather": "nn_gather_kernel",
             "device_neighbors": "neighbors_fused_kernel",
             "reverse_table": "reverse_kernel",
             "pair_u_duals_chem": "pair_u_duals_kernel",
             "zlist_chem": "zlist_kernel", "dbdd_chem": "dbdd_kernel",
             "nn_ut_b_chem": "nn_ut_b_kernel"}


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


def bound_ms(nbytes, flops, fp32=False):
    """The least time of the work: its bytes over the HBM rate or its
    operations over the FP64 tensor cores' rate (float32 work: the FP32
    CUDA cores'), the larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (FP32_FLOPS if fp32 else FP64_FLOPS) * 1e3
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

    return dict(sk.launches(), **sk.shape_launches(), **ak.launches(),
                **nk.launches(), **ck.launches())


def check_launched(counts, path):
    """Every kernel of the path launched, and K4 as often as the rows
    need: once a reference call on a rows path, never on an NN path (on
    the float32 path, counted in their float32 instantiations)."""
    missing = [k for k in PATH_KERNELS[path] if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {path} path: "
                             f"{missing}")
    sfx = "_f32" if path == "streamed_f32" else ""
    k4 = counts["zbl_eav" + sfx] * (path in ROWS_PATHS)
    if counts["pair_scatter_rows" + sfx] != k4:
        raise AssertionError(f"K4 launched {counts['pair_scatter_rows' + sfx]}"
                             f" times on the {path} path, not {k4} (the "
                             f"reference: {counts['zbl_eav' + sfx]})")


def record(rows, name, out, ref, kernel, plain_ms, nbytes, flops,
           library_ms, wrapper=None, shape=None, library=None,
           vector=False, fp32=False, rtol=None, trace=True):
    """Hold a kernel's outputs to its plain version's, time it, and add its
    row to `rows`.  `kernel` is (a call of the wrapper, repetitions to
    time); `wrapper` names the kernel when the row is one of several
    shapes of it; `library`, a call of the library function, is timed
    here, by CUDA events (in place of `library_ms`) and by device time;
    `vector` adds the bound at the FP64 vector rate (work that cannot use
    the tensor cores); `fp32`: a float32 instantiation (phases 22 and 23),
    held to KERNEL_RTOL32 (or `rtol`) and bound at the FP32 CUDA-core
    rate; `trace=False` leaves the row's device ms to the caller (phase
    23's trace in turns)."""
    err_abs, err_rel = rel_err(out, ref)
    b_ms, b_by = bound_ms(nbytes, flops, fp32)
    rtol = rtol or (KERNEL_RTOL32 if fp32 else KERNEL_RTOL)
    ms = timed(*kernel)
    dev_ms = device_time(*kernel) if trace else None
    lib_dev_ms = None
    if library:
        library_ms = timed(library, 20)
        lib_dev_ms = device_time(library, 20)
    print(f"{name}: max_abs_err={err_abs:.3e} max_rel_err={err_rel:.3e}"
          f" ms={ms:.4f} device_ms={dev_ms} plain_ms={plain_ms:.4f}"
          f" bound_ms={b_ms:.4f} ({b_by}) library_ms={library_ms}"
          f" library_device_ms={lib_dev_ms}", flush=True)
    if not err_rel <= rtol:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version ({err_rel:.3e} > {rtol})")
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
    if fp32:
        row["dtype"] = "float32"
    if vector:
        row["bound_ms_fp64_vector"] = max(nbytes / HBM_BYTES_PER_S,
                                          flops / FP64_VECTOR_FLOPS) * 1e3
    rows.append(row)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def config_chunks(on=True):
    """The SNAP calculator's chunks of one config while the block runs (when
    `on`): the plain path's memory at twojmax 14-16 (`LARGE_DROP`)."""
    from fitsnap_tpu_torch.calculators import snap as csnap

    size = csnap.chunk_size
    if on:
        csnap.chunk_size = lambda *args: 1
    try:
        yield
    finally:
        csnap.chunk_size = size


def make_dataset(tmp, seed, device, kind="snap", twojmax=None):
    """Write the synthetic set with truths A_plain @ beta_true + the
    reference, for the SNAP model (`kind="snap"`, the Ta_Linear_JCP2014
    sections), the ACE one ("ace", the Ta_PACE section), quadratic SNAP
    ("quadratic", the Ta_Quadratic_JCP2018 width) on the Ta-shaped configs,
    the InP_JPCA2020 chemflag model ("inp") on the InP-shaped configs, or
    the SNAP model with the zbl + coul/cut + spin reference ("fe") on the
    Fe-shaped configs, whose JSON carries Spins and Charges.  With
    `twojmax`, the SNAP model at that twojmax on the configs of
    `LARGE_COUNTS` (phase 21; kind "tj<twojmax>").

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
                synthetic.inp_configs),
        "fe": ("FE_JSON", synthetic.fe_settings, seed + 10,
               synthetic.fe_configs)}[kind if twojmax is None else "snap"]
    if twojmax is not None:
        folder = f"TJ{twojmax}_JSON"

        def settings(root):
            s = synthetic.ta_settings(root, list(counts))
            s["BISPECTRUM"]["twojmax"] = twojmax
            s["OUTFILE"] = {"metrics": f"Ta_tj{twojmax}_metrics.md",
                            "potential": f"Ta_tj{twojmax}_pot"}
            return s

        counts = {g: n for g, n in LARGE_COUNTS.items()
                  if twojmax < max(LARGE_TJ) or g not in LARGE_DROP}

        def configs(seed):
            return synthetic.ta_configs(seed, counts)
    root = Path(tmp) / folder
    files = synthetic.write_dataset(root, configs(seed))
    ini = Path(tmp) / (f"{kind}.in" if twojmax is None
                       else f"tj{twojmax}.in")
    synthetic.write_ini(ini, settings(root))

    fs0 = FitSnap(str(ini), arglist=["--overwrite"], device=device)
    data = fs0.scrape_configs()
    t0 = time.time()
    with config_chunks(twojmax is not None):
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
            types=conf[2] if len(conf) > 2 else None,
            extra=conf[3] if len(conf) > 3 else None))
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


def k3_operations(p, k1_in):
    """K3's FP64 operations on these inputs, from y's nonzero entries (the
    plan's nonzero y_fac): per atom and row, 4 a nonzero layer-0 factor (B)
    and 4 a nonzero factor of any layer (the y build); per live pair and
    row, 12 a u with a nonzero factor in a layer of the pair's channel (re
    and im, three directions, a multiply-add each).  One channel: every
    live pair is in channel 0."""
    N = k1_in[2].shape[0]
    nc = p.nchem
    nz = p.y_fac.cpu().numpy() != 0                       # (3, ntrip, U)
    chan = p.blk_chan.cpu().numpy()                       # (nc^3, 3)
    mask = k1_in[2].cpu().numpy()
    jel = k1_in[1].cpu().numpy() if nc > 1 else np.zeros_like(mask, int)
    flops = N * nc ** 3 * 4 * (int(nz[0].sum()) + int(nz.sum()))
    for ch in range(nc):
        targets = sum(int((nz & (chan[b] == ch)[:, None, None]).any(0).sum())
                      for b in range(nc ** 3))
        flops += int((mask & (jel == ch)).sum()) * targets * 12
    return flops


def k1_operations(p, npairs, shape="window"):
    """K1's FP64 operations on `npairs` live pairs: a prologue (about 600),
    the monomials of degree <= twojmax (3 multiplies each), 2 an entry of
    the change of basis L and of its four partials L_v (L_v has a nonzero
    for each nonzero of L in a monomial holding the variable v), and 34 a
    column (the three tangents, J and w U).  The recursion shape instead:
    the prologue, 52 an entry of each level's half rows in each of the
    three passes (conj(a) x and conj(b) y with one tangent, 20 each, and
    their combination, 12), 18 a U column (J's two parts in three
    directions) and 2 an entry for utot."""
    from fitsnap_tpu_torch.ops.mono import mono_plan

    if shape == "recursion":
        half = sum((j // 2 + 1) * (j + 1) for j in range(p.twojmax + 1))
        return npairs * (600 + 3 * 52 * half + 18 * p.u_len + 2 * half)

    exps, _, _, L = mono_plan(p.twojmax)
    nz = L != 0
    entries = int(nz.sum()) + sum(int(nz[np.asarray(exps)[:, v] > 0].sum())
                                  for v in range(4))
    return npairs * (600 + 3 * L.shape[0] + 2 * entries + 34 * L.shape[1])


def k1_row(rows, p, k1_in, shape=None):
    """K1 (its chemflag mode when the plan has element channels) against
    its plain version on one chunk's K1 inputs, padding slots exactly 0;
    the row is named `kernel@shape` when a shape is given.  Its bound: per
    live pair the prologue (about 600 flops), the monomials
    (`k1_operations`), the change of basis and its four partials (an FMA an
    entry) and each column's epilogue; the bytes are its inputs, J and
    utot.  Returns the plain (J, ut)."""
    from fitsnap_tpu_torch.kernels import snap_kernels as sk

    N, K = k1_in[2].shape
    U, nc = p.u_len, p.nchem
    name = "pair_u_duals" + ("_chem" if nc > 1 else "")
    k1 = getattr(sk, name)
    out = k1(*k1_in, p)
    if not (out[0].permute(1, 2, 0, 3)[~k1_in[2]] == 0).all():
        raise AssertionError(f"{name}: padding slots not exactly 0")
    ref = sk.pair_u_duals_plain(*k1_in, p)
    import torch

    sms = torch.cuda.get_device_properties(
        k1_in[0].device).multi_processor_count
    k1_shape = sk.pair_u_plan(p, N, K, sms)[0]
    entry = "pair_u_recur" if k1_shape == "recursion" and nc == 1 else name
    record(rows, name + (f"@{shape}" if shape else ""), out, ref,
           (lambda: k1(*k1_in, p), 10),
           timed(lambda: sk.pair_u_duals_plain(*k1_in, p), 3),
           N * K * (3 * 8 + 4 + 1) + N * 4 + 3 * N * K * 2 * U * 8
           + N * nc * 2 * U * 8,
           k1_operations(p, int(k1_in[2].sum().item()), k1_shape), None,
           wrapper=entry, shape=shape)
    return ref


def zlist_library(ut, U, groups, name):
    """K2's library call: torch.bmm over the TPU path's dense term GEMMs
    (the plan's z_dense groups: M (Tg, P, D^2) a group) on one channel's
    ut, at ut's type, timed (ms); None where the dense tables with the
    GEMMs' operands and outputs pass half the card's free memory.  The
    tables' bytes are printed either way."""
    import torch

    N, item = ut.shape[0], ut.element_size()
    table = work = 0
    for g in groups:
        Tg, P, DD = np.asarray(g["M"]).shape
        table += Tg * P * DD * item
        work += 2 * Tg * N * (P + DD) * item
    fits = table + work <= torch.cuda.mem_get_info()[0] // 2
    print(f"{name} library call (torch.bmm, dense term tables): tables "
          f"{table} bytes, operands and outputs {work} bytes at {N} atoms"
          + ("" if fits else ": past half the free memory, not timed"),
          flush=True)
    if not fits:
        return None
    dense = []
    for g in groups:
        gi1 = torch.as_tensor(g["gi1"], device=ut.device).long()
        gi2 = torch.as_tensor(g["gi2"], device=ut.device).long()
        a_r, a_i = ut[:, :U][:, gi1], ut[:, U:][:, gi1]
        b_r, b_i = ut[:, :U][:, gi2], ut[:, U:][:, gi2]
        dense.append(
            ((a_r * b_r - a_i * b_i).transpose(0, 1).contiguous(),
             (a_r * b_i + a_i * b_r).transpose(0, 1).contiguous(),
             torch.as_tensor(g["M"], dtype=ut.dtype, device=ut.device)))
    ms = timed(lambda: [(torch.bmm(pr, M), torch.bmm(pi, M))
                        for pr, pi, M in dense], 20)
    del dense
    torch.cuda.empty_cache()
    return ms


def zlist_sub_row(rows, p, ut, groups, at):
    """K2 and its library call on the chunk's first atoms where the whole
    chunk's dense GEMMs pass half the free memory: the first N / 2^i atoms
    (whole configs: the chunk's atoms are config-major) at which they fit,
    a row `zlist<at>_<n>atoms` of its own."""
    from fitsnap_tpu_torch.kernels import snap_kernels as sk

    n = ut.shape[0]
    while n > 1:
        n //= 2
        sub = ut[:n].contiguous()
        library = zlist_library(sub, p.u_len, groups, f"zlist{at}_{n}atoms")
        if library is not None:
            record(rows, f"zlist{at}_{n}atoms", sk.zlist(sub, p),
                   sk.zlist_plain(sub, p), (lambda: sk.zlist(sub, p), 20),
                   timed(lambda: sk.zlist_plain(sub, p), 5),
                   n * 2 * p.u_len * 8 + 2 * n * p.nz * 8,
                   n * p.z_c.shape[0] * 10, library, wrapper="zlist",
                   shape=f"{at[1:]}_{n}atoms")
            return


def descriptor_checks(rows, p, k1_in, shape=None, k2_library=True):
    """K1, K2 and K3 (their chemflag modes when the plan has element
    channels) and K6q (quadraticflag) against their plain versions on one
    chunk's K1 inputs; rows are named `kernel@shape` when a shape is given.
    K2's library call needs the plan's dense TPU term tables: True builds
    them anew (about a minute at twojmax 16), a list takes the plan's
    groups (`shared_plans` keeps them), False leaves the call out.
    Returns the plain (B, dB/dD) the chunk's rows are built from."""
    import torch
    from fitsnap_tpu_torch.kernels import snap_kernels as sk
    from fitsnap_tpu_torch.ops import snap as ops
    from fitsnap_tpu_torch.ops.cg import build_snap_plan

    N, K = k1_in[2].shape
    U, nc, W = p.u_len, p.nchem, p.nb_base
    chem = nc > 1
    sfx = "_chem" if chem else ""
    at = f"@{shape}" if shape else ""

    def name(kernel):
        return kernel + sfx if kernel != "quad_chain" else kernel

    J, ut = k1_row(rows, p, k1_in, shape)

    # K2 (every ordered channel pair in one launch), with torch.bmm over the
    # TPU path's dense term GEMMs as library call for one channel
    k2 = getattr(sk, "zlist" + sfx)
    k2_plain = getattr(sk, "zlist" + sfx + "_plain")
    out = k2(ut, p)
    ref = k2_plain(ut, p)
    library = None
    if k2_library is False:
        print(f"{name('zlist')}{at} library call not timed: its dense term "
              f"tables are the plan's, built anew", flush=True)
    elif not chem:
        groups = build_snap_plan(p.twojmax).z_dense["groups"] \
            if k2_library is True else k2_library
        library = zlist_library(ut, U, groups, name("zlist") + at)
        if library is None:
            zlist_sub_row(rows, p, ut, groups, at)
    z_ptr = p.z_ptr.cpu().numpy()
    empty = torch.as_tensor(np.nonzero(z_ptr[1:] == z_ptr[:-1])[0],
                            device=ut.device)
    if not all((z[..., empty] == 0).all() for z in out):
        raise AssertionError(f"{name('zlist')}: outputs without terms not "
                             f"exactly 0")
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
        library = None
        if inter < torch.cuda.mem_get_info()[0] // 2:
            def library():
                return torch.einsum("awnu,akn,caku->awkc", dbdu, oh, J)
        else:
            print(f"dbdd_chem library call not timed: its {inter / 1e9:.1f}"
                  f" GB intermediate exceeds half the free memory",
                  flush=True)
    else:
        def k3():
            return sk.dbdd(ut, z_r, z_i, J, p)

        def k3_plain():
            return sk.dbdd_plain(ut, z_r, z_i, J, p)

        dbdu = ops._dbdu_ylist(ut, p, (z_r, z_i))

        def library():
            return torch.einsum("awu,caku->awkc", dbdu, J)
    out, ref = k3(), k3_plain()
    pad = ~k1_in[2]
    if not (out[1].permute(0, 2, 1, 3)[pad] == 0).all():
        raise AssertionError(f"{name('dbdd')}: padding slots not exactly 0")
    k3_flops = k3_operations(p, k1_in)
    k3_bytes = (N * nc * 2 * U + 2 * N * nc * nc * p.nz + 3 * N * K * 2 * U
                + N * W + N * W * K * 3) * 8 + (N * K * 4 if chem else 0)
    entry = {"level": "dbdd_level", "slab": "dbdd_slab"}.get(
        sk.dbdd_shape(p, K), name("dbdd"))
    record(rows, name("dbdd") + at, out, ref, (k3, 10), timed(k3_plain, 3),
           k3_bytes, k3_flops, None, wrapper=entry, shape=shape,
           library=library)
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
    call; `types` replaces the chunk's (the ACE rows pass all zeros)."""
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


def kernel_checks(calc, data, seed):
    """K1-K5 (K5 also in its coul/cut and spin modes), K7, K8 and K8r vs
    plain on the first Compressed_BCC chunk (8 x 128 x 64)."""
    from fitsnap_tpu_torch.kernels import snap_kernels as sk
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

    # K5, the whole reference, on the chunk's host neighbor lists; then its
    # coul/cut and spin modes with seeded charges and spins
    zbl_check(rows, args, calc.refspec)
    ref_mode_checks(rows, args, seed)
    nlisted = int(mask.sum().item())

    # K8 and K8r on the chunk's positions batch
    s_table = fit.batch_shift_table([pc.cell for pc in packed], calc.cutoff)
    pos_batch = fit.put_batch(fit.pack_batch_pos(
        packed, A, C, s_table, np.float64), disp.device)
    ph, pl, sh, sl, _, nat32 = (x[0] for x in pos_batch[:6])
    S = sh.shape[1]
    k8_args = (ph, pl, sh, sl, nat32, calc.cutoff, K)
    out = sk.device_neighbors(*k8_args)
    ref = sk.device_neighbors_plain(*k8_args)
    neighbors_check(rows, k8_args, out, ref)
    DIGESTS["device_neighbors (SNAP chunk)"] = digest(out)
    print(f"device_neighbors: S={S} candidates/atom={S * A} listed="
          f"{int(out[2].sum().item())} (host lists {nlisted})", flush=True)
    k8_cap_check(rows, calc.cutoff)
    _, njidx, nmask = out
    reverse_check(rows, njidx, nmask)
    del out, ref

    # K7 on the chunk's rows, with the truths and weights of the batch
    rows_in = calc.rows(*args)
    truths, weights = pos_batch[7:10], pos_batch[10:13]
    truths, weights = [x[0] for x in truths], [x[0] for x in weights]
    normal_check(rows, rows_in, truths, weights, nat32, types, T, True)
    return rows


def zbl_check(rows, args, spec, shape=None):
    """K5, the whole ZBL reference (`zbl_eav`: energy, forces and virial in
    one launch), against its plain version (the per-slot gradient, then
    K4's plain scatter at width 1) on one chunk's host lists: 1e-11, two
    calls bit for bit, the digest printed.  Its bound: disp, jidx, mask,
    rev and types read once, energy, forces and virial written once; its
    operations each listed slot's energy and gradient (four exps) from
    both sides."""
    import torch
    from fitsnap_tpu_torch.kernels import snap_kernels as sk
    from fitsnap_tpu_torch.ops.refpot import zbl_table

    disp, jidx, mask, rev, types, _, _ = args
    C, A, K = mask.shape
    zc = spec.zbl
    table = zbl_table(zc, disp.device)
    k5_args = (disp, jidx, mask, rev, types, table, zc.cut_inner,
               zc.cut_outer)
    name = "zbl_eav" + (f"@{shape}" if shape else "")

    def call():
        return sk.zbl_eav(*k5_args)

    def plain():
        return sk.zbl_eav_plain(*k5_args)

    out, again, ref = call(), call(), plain()
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        raise AssertionError(f"{name}: two calls differ")
    DIGESTS[name] = digest(out)
    nlisted = int(mask.sum().item())
    nbytes = (disp.numel() * 8 + (jidx.numel() + rev.numel()
                                  + types.numel()) * 4 + mask.numel()
              + table.numel() * 8 + (C + C * A * 3 + C * 6) * 8)
    flops = 2 * nlisted * (4 * EXP_OPS + 40)
    print(f"{name}: C={C} A={A} K={K} R={rev.shape[2]} listed={nlisted} "
          f"types={table.shape[0]}", flush=True)
    record(rows, name, out, ref, (call, 20), timed(plain, 5), nbytes, flops,
           None, wrapper="zbl_eav", shape=shape)
    del out, again, ref
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def ref_mode_checks(rows, args, seed):
    """K5's ref_eav mode (`zbl_eav` with `extra`) on the SNAP chunk's host
    lists with seeded charges (N(0, 0.4)) and unit spins, zero on padding
    atoms: coul/cut, the spin term, and zbl + coul/cut + spin (K5_MODES),
    each against its plain version (1e-11), two calls bit for bit, the
    digest printed.  Its bound: zbl_eav's bytes, the charges and spins read
    once; its operations each listed slot's terms from both sides (the
    Coulomb term 10, the spin term's two profiles, two exps, on its own
    side only)."""
    import torch
    from fitsnap_tpu_torch.kernels import snap_kernels as sk
    from fitsnap_tpu_torch.ops import refpot

    disp, jidx, mask, rev, types, natoms, _ = args
    C, A, K = mask.shape
    dev = disp.device
    rng = np.random.default_rng(seed + 11)
    real = torch.arange(A, device=dev)[None, :] < natoms[:, None]
    q = torch.as_tensor(rng.normal(0.0, 0.4, (C, A)), device=dev) * real
    spins = torch.as_tensor(rng.normal(size=(C, A, 3)), device=dev)
    spins = spins / spins.norm(dim=-1, keepdim=True) * real[..., None]
    nlisted = int(mask.sum().item())
    for mode, decls in K5_MODES.items():
        spec = refpot.parse_reference(SimpleNamespace(lmp_pairdecl=decls), 1)
        zc = spec.zbl
        table = (refpot.zbl_table(zc, dev) if zc is not None
                 else disp.new_zeros((1, 1, 6)))
        k5_args = (disp, jidx, mask, rev, types, table,
                   *((zc.cut_inner, zc.cut_outer) if zc else (0.0, 0.0)))
        kw = {"charges": q if spec.coul else None,
              "spins": spins if spec.spin else None,
              "extra": refpot.extra_table(spec, dev)}

        def call(a=k5_args, k=kw):
            return sk.zbl_eav(*a, **k)

        def plain(a=k5_args, k=kw):
            return sk.zbl_eav_plain(*a, **k)

        name = f"zbl_eav@{mode}"
        out, again, ref = call(), call(), plain()
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            raise AssertionError(f"{name}: two calls differ")
        DIGESTS[name] = digest(out)
        nbytes = (disp.numel() * 8 + (jidx.numel() + rev.numel()
                                      + types.numel()) * 4 + mask.numel()
                  + table.numel() * 8 + 9 * 8 + (C + C * A * 3 + C * 6) * 8
                  + (C * A * 8 if spec.coul else 0)
                  + (C * A * 24 if spec.spin else 0))
        flops = (2 * nlisted * ((4 * EXP_OPS + 40 if zc else 0)
                                + (10 if spec.coul else 0))
                 + (nlisted * (2 * EXP_OPS + 30) if spec.spin else 0))
        print(f"{name}: C={C} A={A} K={K} listed={nlisted} energy "
              f"{ref[0].sum().item():.6e}", flush=True)
        record(rows, name, out, ref, (call, 20), timed(plain, 5), nbytes,
               flops, None, wrapper="zbl_eav", shape=f"SNAP chunk {mode}")
        del out, again, ref
    torch.cuda.empty_cache()


def k8_work(ph, sh, natoms, cutoff):
    """(real candidates, distances) a binned search over K8's inputs must
    evaluate: each real candidate pos[j] + svec[s] binned once, then for
    each real atom the candidates of the 27 bins (side = the cutoff) around
    its own; counted here with numpy, apart from the kernel's own grid."""
    ph, sh, natoms = (x.cpu().numpy() for x in (ph, sh, natoms))
    nbinned = ndist = 0
    for c, na in enumerate(natoms):
        if na == 0:
            continue
        pos = ph[c, :na]
        cand = (pos[None, :, :] + sh[c][:, None, :]).reshape(-1, 3)
        lo = pos.min(0) - cutoff
        atom_bin = np.floor((pos - lo) / cutoff).astype(np.int64)
        cand_bin = np.floor((cand - lo) / cutoff).astype(np.int64)
        n = atom_bin.max(0) + 2
        keep = ((cand_bin >= 0) & (cand_bin < n)).all(1)
        counts = np.bincount(np.ravel_multi_index(cand_bin[keep].T, n),
                             minlength=int(np.prod(n))).reshape(n)
        nbinned += len(cand)
        for d in itertools.product((-1, 0, 1), repeat=3):
            b = atom_bin + np.array(d)
            ndist += int(counts[tuple(b.T)].sum())
    return nbinned, ndist


def neighbors_check(rows, args, out, ref, shape=None, plain_reps=3):
    """Hold K8's outputs to its plain version's (mask and jidx equal, disp
    within 1e-12) and add its row: its bound by its bytes and the
    operations of a binned search (9 a binned candidate: the point and its
    bin coordinates; 9 an evaluated distance: 3 differences, 3 squares, 2
    sums, the comparison).  K8's split launch shape (the bin pass, then
    the select pass) is forced on the same inputs and gets a row of its
    own, and the two are timed in turn, fused - split - split - fused, by
    device time (each the sum of its kernels' device ms over 20 calls)."""
    import torch
    from fitsnap_tpu_torch.kernels import snap_kernels as sk

    ph, pl, sh, sl, nat32, cutoff, K = args
    C, A = ph.shape[:2]
    S = sh.shape[1]
    name = "device_neighbors" + (f"@{shape}" if shape else "")

    def fused():
        return sk.device_neighbors(*args)

    def split():
        sk.K8_FUSED_ATOMS = 0
        try:
            return sk.device_neighbors(*args)
        finally:
            sk.K8_FUSED_ATOMS = fused_atoms

    fused_atoms = sk.K8_FUSED_ATOMS
    shapes = [("fused", out, fused), ("split", split(), split)]
    for tag, o, _ in shapes:
        if not (torch.equal(o[2], ref[2]) and torch.equal(o[1], ref[1])):
            raise AssertionError(f"{name} ({tag}): mask or jidx differs "
                                 f"from its plain version")
        disp_err = (o[0] - ref[0]).abs().max().item()
        if not disp_err <= 1e-12:
            raise AssertionError(f"{name} ({tag}): disp differs from its "
                                 f"plain version by {disp_err:.3e}")
    nbinned, ndist = k8_work(ph, sh, nat32, cutoff)
    print(f"{name}: binned candidates {nbinned}, distances of the 27 bins "
          f"{ndist} (S A^2 = {C * S * A * A})", flush=True)
    plain_ms = timed(lambda: sk.device_neighbors_plain(*args), plain_reps)
    for tag, o, fn in shapes:
        record(rows, name if tag == "fused" else
               "device_neighbors (split shape)" + (f"@{shape}" if shape
                                                   else ""),
               o[:1], ref[:1], (fn, 20), plain_ms,
               C * A * 3 * 8 * 2 + C * S * 3 * 8 * 2 + C * 4
               + C * A * K * (24 + 4 + 1), 9 * (nbinned + ndist), None,
               wrapper="device_neighbors", shape=shape)
        rows[-1]["launch_shape"] = tag
        if tag == "split":
            rows[-1]["note"] = ("forced: the main path's calls at this size "
                                "run the fused shape (the launches are the "
                                "wrapper's)")
    times = {"fused": [], "split": []}
    for tag, fn in (("fused", fused), ("split", split), ("split", split),
                    ("fused", fused)):
        times[tag].append(device_time(fn, 20))
    per_kernel = {k: v / 20 for k, v in profile_kernels(
        lambda: [split() for _ in range(20)]).items()}
    print(f"{name} launch shapes, device ms (fused - split - split - "
          f"fused): fused {times['fused']} split {times['split']} "
          f"(split by kernel: {per_kernel})", flush=True)


def k8_cap_check(rows, cutoff, seed=7):
    """K8 past the shared-memory cap it had before: 2 configs of a jittered
    8 x 8 x 8 bcc supercell (1,024 atoms, a = 3.30 A, seeded jitter of
    0.05 A), S = 27, at the Ta set's cutoff, K the largest neighbor count
    rounded up to 8."""
    import torch
    from fitsnap_tpu_torch.kernels import snap_kernels as sk
    from fitsnap_tpu_torch.ops.neighbors import count_neighbors
    from fitsnap_tpu_torch.parallel import fit
    from fitsnap_tpu_torch.tools import synthetic

    rng = np.random.default_rng(seed)
    pos0, rows_ = synthetic.supercell(synthetic.BCC, 3.30, (8, 8, 8))
    cell = rows_.T
    pos = np.stack([pos0 + 0.05 * rng.normal(size=pos0.shape)
                    for _ in range(2)])
    A = pos.shape[1]
    K = max(count_neighbors(p, cell, A, cutoff) for p in pos)
    K = -(-K // 8) * 8
    shifts = np.asarray(fit.batch_shift_table([cell], cutoff), np.float64)
    svec = np.stack([shifts @ cell.T] * 2)

    def dev(x, dtype=torch.float64):
        return torch.as_tensor(x, dtype=dtype, device="cuda")

    args = (dev(pos), dev(np.zeros_like(pos)), dev(svec),
            dev(np.zeros_like(svec)), dev([A, A], torch.int32), cutoff, K)
    shape = [2, A, K]
    print(f"device_neighbors past the old cap: C=2 A={A} S={len(shifts)} "
          f"K={K} (12 S A = {12 * len(shifts) * A} bytes)", flush=True)
    out = sk.device_neighbors(*args)
    ref = sk.device_neighbors_plain(*args)
    neighbors_check(rows, args, out, ref, shape, plain_reps=2)
    del out, ref
    torch.cuda.empty_cache()


def reverse_check(rows, jidx, mask, shape=None):
    """K8r against its plain version (equal, nothing dropped) on one
    chunk's lists; beside it `torch.sort(stable=True)` of the masked
    destinations, which gives the table's order but not the padded table
    (no one PyTorch call does)."""
    import torch
    from fitsnap_tpu_torch.kernels import snap_kernels as sk

    C, A, K = mask.shape
    out = sk.reverse_table(jidx, mask)
    ref = sk.reverse_table_plain(jidx, mask)
    if not (torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
            and int(out[1].sum().item()) == 0):
        raise AssertionError("reverse_table differs from its plain version "
                             "or dropped entries")
    # the function needs O(A K) integer work, so its bound is its bytes
    record(rows, "reverse_table" + (f"@{shape}" if shape else ""),
           [x.double() for x in out], [x.double() for x in ref],
           (lambda: sk.reverse_table(jidx, mask), 20),
           timed(lambda: sk.reverse_table_plain(jidx, mask), 5),
           C * A * K * (4 + 1 + 4) + C * 4, 0, None,
           wrapper="reverse_table", shape=[C, A, K])
    dest = torch.where(mask, jidx, A).reshape(C, A * K)

    def order():
        return torch.sort(dest, dim=1, stable=True)

    rows[-1]["sort_ms"] = timed(order, 20)
    rows[-1]["sort_device_ms"] = device_time(order, 20)
    print(f"reverse_table{'@' + shape if shape else ''}: torch.sort "
          f"(stable) of the masked destinations ms={rows[-1]['sort_ms']:.4f}"
          f" device_ms={rows[-1]['sort_device_ms']}", flush=True)


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


def k13_row(rows, plan, k13_in, npairs, shape):
    """K13 against its plain version on one chunk's inputs (1e-11), two
    calls bit for bit with the digest printed; returns the plain (A, Jp).
    Its bound: the inputs read once, A and Jp written once (a spline plan:
    and the table bins the live pairs read); its operations per live pair
    the radial recursion (about 20 flops per n; a spline's cubic and its
    derivative 12) and the Ylm recursion with its gradient (about 60 per
    (l, m)), then 16 per A-slot (phi and three tangents, re and im)."""
    import torch
    from fitsnap_tpu_torch.kernels import ace_kernels as ak

    N, K = k13_in[2].shape
    nA, nrad, ny = plan.nA, plan.nradbase, (plan.lmax + 1) ** 2
    name = "ace_pair_basis" + ("" if shape == "Ta_PACE" else f"@{shape}")
    radial_ops, table_bytes = 20 * nrad, 0
    if plan.spline_delta:
        # a spline radial: per n Horner's rule and its derivative (12); the
        # bins the live pairs read, 4 nrad doubles each distinct (bond, bin)
        disp, jel, sm, ie = k13_in
        r = torch.sqrt((disp * disp).sum(-1))[sm]
        bond = (ie[:, None] * plan.numtypes + jel)[sm].long()
        nlut = int(np.ceil(float(np.max(plan.rcut)) / plan.spline_delta)) + 1
        bins = torch.unique(bond * nlut
                            + torch.floor(r / plan.spline_delta).long())
        radial_ops, table_bytes = 12 * nrad, bins.numel() * nrad * 4 * 8
    out = ak.ace_pair_basis(*k13_in, plan)
    again = ak.ace_pair_basis(*k13_in, plan)
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        raise AssertionError(f"{name}: two calls differ")
    DIGESTS[name] = digest(out)
    del again
    ref = ak.ace_pair_basis_plain(*k13_in, plan)
    record(rows, name, out, ref, (lambda: ak.ace_pair_basis(*k13_in, plan),
                                  10),
           timed(lambda: ak.ace_pair_basis_plain(*k13_in, plan), 3),
           N * K * (24 + 4 + 1) + N * 4 + N * 2 * nA * 8
           + 3 * N * K * 2 * nA * 8 + nA * 16 + table_bytes,
           npairs * (radial_ops + 60 * ny + 16 * nA), None,
           wrapper="ace_pair_basis", shape=shape)
    rows[-1]["spline_delta"] = plan.spline_delta
    rows[-1]["lmax"], rows[-1]["nA"] = plan.lmax, nA
    rows[-1]["conventions"] = [plan.radial, plan.ylm]
    warps, nw_log, rl, smem = ak.k13_shape(plan, K)
    rows[-1]["launch_shape"] = {"warps": warps, "tile": 1 << nw_log,
                                "record": rl, "smem_bytes": smem}
    del out
    return ref


def ace_pair_checks(rows, plan, disp, jelem, smask, types, shape):
    """K13 and K14 against their plain versions on one chunk; returns the
    plain dB/dD."""
    import torch
    from fitsnap_tpu_torch.kernels import ace_kernels as ak
    from fitsnap_tpu_torch.ops import ace as ops

    C, A, K = smask.shape
    N = C * A
    nA, nl = plan.nA, len(plan.labels)
    R = plan.rank_max
    k13_in = (disp.reshape(N, K, 3), jelem.reshape(N, K),
              smask.reshape(N, K), types.reshape(N))
    npairs = int(smask.sum().item())
    tabs = ak.kernel_tables(plan)
    print(f"ACE kernel inputs ({shape}): C={C} A={A} K={K} pairs={npairs} "
          f"labels={nl} A-slots={nA} terms={len(plan.t_coef)} rank={R} "
          f"dB/dA entries={tabs.nE} float64", flush=True)
    suffix = "" if shape == "Ta_PACE" else f"@{shape}"

    A_, Jp = k13_row(rows, plan, k13_in, npairs, shape)
    ielem = k13_in[3]

    # K14: work of the labels whose central element is the atom's: per term
    # R - 1 complex products (6 flops) and its coefficient (2), per
    # contribution to dB/dA the cofactor's R - 2 products and 4, per live
    # pair, label entry and direction 4 (re and im multiply-adds)
    out = ak.ace_b_dbdd(A_, Jp, ielem, plan)
    ref = ak.ace_b_dbdd_plain(A_, Jp, ielem, plan)
    mu0 = np.asarray(plan.t_mu0)
    n_terms = np.diff(tabs.lab_t)
    n_entries = np.diff(tabs.lab_e)
    fact = np.asarray(plan.t_fact)
    n_contrib = np.add.reduceat((fact != 0).sum(1), tabs.lab_t[:-1])
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
    table_bytes = (len(plan.t_coef) * (R * 4 + 8) + (nl + 1) * 4 * 2
                   + tabs.nE * 4 + (plan.numtypes + 1) * 4)
    if not (out[1].permute(0, 2, 1, 3)[~smask.reshape(N, K)] == 0).all():
        raise AssertionError("ace_b_dbdd: padding slots not exactly 0")
    record(rows, "ace_b_dbdd" + suffix, out, ref,
           (lambda: ak.ace_b_dbdd(A_, Jp, ielem, plan), 10),
           timed(lambda: ak.ace_b_dbdd_plain(A_, Jp, ielem, plan), 3),
           N * 2 * nA * 8 + 3 * N * K * 2 * nA * 8 + N * 4 + N * nl * 8
           + N * nl * K * 3 * 8 + table_bytes, flops, None,
           wrapper="ace_b_dbdd", shape=shape,
           library=lambda: torch.einsum("alp,cakp->alkc", dbda, Jp))
    del out, dbda, A_, Jp
    return ref[1]


def ace_kernel_checks(calc, data, seed):
    """K13 and K14 vs plain at the Ta_PACE plan on the first Compressed_BCC
    chunk (8 x 128 x 64), then K4 at the ACE width and K13 at lmax 8, in
    the three other convention pairs and with spline radials (delta
    0.001) on that chunk, K13 and K14 at the InP-shaped plan on a seeded
    two-element chunk (8 x 64 atoms), K13 there with spline radials too,
    and K7 in the ACE layout (two leading constant columns) on the rows of
    the latter."""
    import torch
    from fitsnap_tpu_torch.calculators.ace import _within_rcut, ace_rows
    from fitsnap_tpu_torch.kernels import snap_kernels as sk
    from fitsnap_tpu_torch.ops.ace import build_ace_plan
    from fitsnap_tpu_torch.ops.refpot import RefSpec

    rows = []
    chunk = [d for d in data if d["Group"] == "Compressed_BCC"][:8]
    packed, buckets = calc.host_preprocess(chunk)
    _, args = next(iter(calc.batches(packed, buckets)))
    disp, jidx, mask, _, types, _, _ = args
    dev = disp.device
    jelem, inside = _within_rcut(disp, jidx, types, calc.plan)
    smask = mask & inside
    dBdD = ace_pair_checks(rows, calc.plan, disp, jelem, smask, types,
                           "Ta_PACE")
    # K4 as the ACE rows call it: the labels' columns, one type block
    scatter_check(rows, args, smask, dBdD, 1, "Ta_PACE",
                  torch.zeros_like(types))
    del dBdD
    torch.cuda.empty_cache()
    # K13 past its old limits on the same chunk: lmax 8, and the Ta_PACE
    # plan in the three other convention pairs
    C, A, K = mask.shape
    plan8 = build_ace_plan(SimpleNamespace(**LMAX8_SHAPE))
    plans = [(plan8, "lmax8")] + [
        (dataclasses.replace(calc.plan, radial=radial, ylm=ylm, tables={}),
         f"Ta_PACE {radial}/{ylm}") for radial, ylm in K13_CONVENTIONS] + [
        (dataclasses.replace(calc.plan, spline_delta=SPLINE_DELTA,
                             tables={}), "Ta_PACE spline")]
    for plan, shape in plans:
        jel, ins = _within_rcut(disp, jidx, types, plan)
        sm = mask & ins
        k13_in = (disp.reshape(-1, K, 3), jel.reshape(-1, K),
                  sm.reshape(-1, K), types.reshape(-1))
        print(f"K13 row {shape}: lmax={plan.lmax} A-slots={plan.nA} "
              f"radial functions={plan.nradbase} conventions="
              f"{plan.radial}/{plan.ylm}", flush=True)
        k13_row(rows, plan, k13_in, int(sm.sum().item()), shape)
        del jel, ins, sm, k13_in
        torch.cuda.empty_cache()
    del disp, jidx, mask, jelem, inside, smask, args
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
    # K13 with the InP plan's spline radials (four bonds' tables)
    K = mask.shape[2]
    spline = dataclasses.replace(plan, spline_delta=SPLINE_DELTA, tables={})
    k13_row(rows, spline, (disp.reshape(-1, K, 3), jelem.reshape(-1, K),
                           smask.reshape(-1, K), types.reshape(-1)),
            int(smask.sum().item()), "InP_shape spline")
    torch.cuda.empty_cache()

    # K8r on the chunk's host lists
    reverse_check(rows, jidx, mask, "InP_shape")

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
    (Compressed_BCC, Displaced_ZB64): K1-K3 (chemflag modes), K6q, K4, K5
    at the two-type InP chunk, and K7 on the chunk's rows."""
    import torch
    from fitsnap_tpu_torch.kernels import snap_kernels as sk

    group = {"quadratic": "Compressed_BCC", "inp": "Displaced_ZB64"}[kind]
    shape = {"quadratic": "Ta_Quadratic", "inp": "InP"}[kind]
    _, args, k1_in, smask = snap_chunk(calc, data, group)
    C, A, K = smask.shape
    p = calc.params
    print(f"{shape} kernel inputs: C={C} A={A} K={K} pairs="
          f"{int(smask.sum().item())} twojmax={p.twojmax} channels="
          f"{p.nchem} base width={p.nb_base} width={calc.desc_width()} "
          f"float64", flush=True)
    rows = []
    B, G = descriptor_checks(rows, p, k1_in, shape)
    scatter_check(rows, args, smask, G, calc.numtypes, shape)
    del B, G
    if kind == "inp":
        # K5, the whole reference, at the two-type chunk; K9 in its
        # element-channel mode (the chemflag PAS prep's kernel) on its atoms
        zbl_check(rows, args, calc.refspec, shape)
        k9_row(rows, k1_in, p, "_chem@InP", [C, A, K])
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
    if kind in BETA_KINDS or (kind != "ace" and cond <= BETA_COND):
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


def streamed_path(fs, a_plain, beta, seed, device, kind="snap", keep=None):
    """Drive parallel/fit.py on `device` over FitSnap's configs of the
    kind's STREAM_GROUPS, with the SNAP model of the set ("snap",
    "quadratic", "inp") or, through `ace_kernel`, the ACE one ("ace");
    returns (launch counts, timings, checks).  `keep` (a dict) receives
    the pass (`one_pass`) and its normal equations (`result`), for phase
    20."""
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
    if keep is not None:
        keep.update(one_pass=one_pass, result=(AtA, Atb, nrows),
                    evaluate=evaluate)
    kernel_ms = profile_kernels(one_pass)
    if kernel_ms:
        t["device_ms_per_pass"] = sum(kernel_ms.values())
        t["device_busy_share"] = t["device_ms_per_pass"] / 1e3 \
            / t["steady_pass"]
    print(f"streamed pass ({kind}) device time by kernel (ms): " + (json.dumps(
        {k: round(v, 4) for k, v in kernel_ms.items()})
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
    if kind in BETA_KINDS or (kind != "ace" and cond <= BETA_COND):
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
# phase 22: the float32 streamed fit
# ---------------------------------------------------------------------------


def ulps32(a, b):
    """The largest distance between two float32 tensors in ulps of the
    larger magnitude of each pair."""
    a, b = a.double(), b.double()
    ulp = a.abs().maximum(b.abs()).clamp(min=1e-30) * EPS32
    return ((a - b).abs() / ulp).max().item()


def f32_kernel_checks(calc, data, device="cuda"):
    """Phase 22's kernels: K8, K1 (window shape), K2, K3 (whole rows), K4,
    K5 (`zbl_eav`) and K7 in their float32 instantiations against their
    plain float32 versions on phase 3's chunk (the first Compressed_BCC
    chunk, 8 x 128 x 64), its positions packed at float32 (hi/lo) and every
    later input made from them by the float32 kernels: KERNEL_RTOL32,
    K8's mask and jidx and K8r's table exactly and K8's disp within
    K8_ULPS32; every output at float32 (K7: AtA and Atb float64, A^T r
    float32).  Bounds: bytes at 4 a float, operations at the FP32
    CUDA-core rate; library calls as phase 3's, at float32."""
    import torch
    from fitsnap_tpu_torch.calculators.snap import pair_masks, snap_rows
    from fitsnap_tpu_torch.kernels import snap_kernels as sk
    from fitsnap_tpu_torch.ops import snap as ops
    from fitsnap_tpu_torch.ops.cg import build_snap_plan
    from fitsnap_tpu_torch.ops.refpot import zbl_table
    from fitsnap_tpu_torch.parallel import fit

    f32 = torch.float32
    packed, args, _, _ = snap_chunk(calc, data, "Compressed_BCC", 8)
    types = args[4]
    C, A, K = args[2].shape
    N, T = C * A, calc.numtypes
    p = calc.params.cast(f32)
    U, W = p.u_len, p.nb_base
    s_table = fit.batch_shift_table([pc.cell for pc in packed], calc.cutoff)
    batch = [x[0] for x in fit.put_batch(fit.pack_batch_pos(
        packed, A, C, s_table, np.float32), device)]
    ph, pl, sh, sl, _, nat32, cell = batch[:7]
    S = sh.shape[1]
    rows = []

    def check32(name, out):
        if not all(x.dtype == f32 for x in out):
            raise AssertionError(f"{name}: an output is not float32: "
                                 f"{[x.dtype for x in out]}")

    # K8, and K8r on its lists (K8r's row is phase 3's: integers only)
    k8_args = (ph, pl, sh, sl, nat32, calc.cutoff, K)
    out = sk.device_neighbors(*k8_args)
    ref = sk.device_neighbors_plain(*k8_args)
    check32("device_neighbors_f32", out[:1])
    ulps = ulps32(out[0], ref[0])
    if not (torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2])
            and ulps <= K8_ULPS32):
        raise AssertionError(f"device_neighbors_f32: mask or jidx differs, "
                             f"or disp by {ulps} ulps")
    nbinned, ndist = k8_work(ph.double(), sh.double(), nat32, calc.cutoff)
    record(rows, "device_neighbors_f32", out[:1], ref[:1],
           (lambda: sk.device_neighbors(*k8_args), 20),
           timed(lambda: sk.device_neighbors_plain(*k8_args), 3),
           C * A * 3 * 4 * 2 + C * S * 3 * 4 * 2 + C * 4
           + C * A * K * (12 + 4 + 1), 9 * (nbinned + ndist), None,
           wrapper="device_neighbors_f32", fp32=True)
    rows[-1]["disp_ulps"] = ulps
    disp, jidx, mask = out
    rev, dropped = sk.reverse_table(jidx, mask)
    rref, dref = sk.reverse_table_plain(jidx, mask)
    if not (torch.equal(rev, rref) and torch.equal(dropped, dref)
            and int(dropped.sum().item()) == 0):
        raise AssertionError("reverse_table on the float32 lists differs "
                             "from its plain version or dropped entries")
    print(f"float32 kernel inputs: C={C} A={A} K={K} S={S} listed="
          f"{int(mask.sum().item())}; device_neighbors_f32 disp within "
          f"{ulps} ulps of its plain version", flush=True)

    # K1-K3 on the float32 lists, the plan's float32 tables
    jelem, smask = pair_masks(calc.params, disp, jidx, mask, types)
    k1_in = (disp.reshape(N, K, 3), jelem.reshape(N, K), smask.reshape(N, K),
             types.reshape(N))
    npairs = int(smask.sum().item())
    out = sk.pair_u_duals(*k1_in, p)
    check32("pair_u_duals_f32", out)
    if not (out[0].permute(1, 2, 0, 3)[~k1_in[2]] == 0).all():
        raise AssertionError("pair_u_duals_f32: padding slots not exactly 0")
    ref = sk.pair_u_duals_plain(*k1_in, p)
    record(rows, "pair_u_duals_f32", out, ref,
           (lambda: sk.pair_u_duals(*k1_in, p), 10),
           timed(lambda: sk.pair_u_duals_plain(*k1_in, p), 3),
           N * K * (3 * 4 + 4 + 1) + N * 4 + 3 * N * K * 2 * U * 4
           + N * 2 * U * 4, k1_operations(p, npairs), None,
           wrapper="pair_u_duals_f32", fp32=True)
    J, ut = ref
    out = sk.zlist(ut, p)
    ref = sk.zlist_plain(ut, p)
    check32("zlist_f32", out)
    library = zlist_library(ut, U, build_snap_plan(p.twojmax)
                            .z_dense["groups"], "zlist_f32")
    record(rows, "zlist_f32", out, ref, (lambda: sk.zlist(ut, p), 20),
           timed(lambda: sk.zlist_plain(ut, p), 5),
           N * 2 * U * 4 + 2 * N * p.nz * 4, N * p.z_c.shape[0] * 10,
           library, wrapper="zlist_f32", fp32=True)
    z_r, z_i = ref
    out = sk.dbdd(ut, z_r, z_i, J, p)
    ref = sk.dbdd_plain(ut, z_r, z_i, J, p)
    check32("dbdd_f32", out)
    if not (out[1].permute(0, 2, 1, 3)[~k1_in[2]] == 0).all():
        raise AssertionError("dbdd_f32: padding slots not exactly 0")
    dbdu = ops._dbdu_ylist(ut, p, (z_r, z_i))
    record(rows, "dbdd_f32", out, ref,
           (lambda: sk.dbdd(ut, z_r, z_i, J, p), 10),
           timed(lambda: sk.dbdd_plain(ut, z_r, z_i, J, p), 3),
           (N * 2 * U + 2 * N * p.nz + 3 * N * K * 2 * U + N * W
            + N * W * K * 3) * 4, k3_operations(p, k1_in), None,
           wrapper="dbdd_f32", fp32=True,
           library=lambda: torch.einsum("awu,caku->awkc", dbdu, J))
    B, G = ref
    del out, dbdu, J, z_r, z_i
    torch.cuda.empty_cache()

    # K4 on the float32 gradients, index_add_ of the scatter as library
    real = (torch.arange(A, device=disp.device)[None, :]
            < nat32[:, None]).to(f32)
    G = (G.reshape(C, A, W, K, 3) * real[..., None, None, None]).contiguous()
    k4_args = (G, disp, smask, rev, types, T)
    out = sk.pair_scatter_rows(*k4_args)
    ref = sk.pair_scatter_rows_plain(*k4_args)
    check32("pair_scatter_rows_f32", out)
    dest = (torch.arange(C, device=disp.device)[:, None, None] * A
            + jidx.long())[smask]
    g_rows = G.permute(0, 1, 3, 2, 4)[smask].reshape(-1, W * 3)
    scat = torch.zeros((N, W * 3), dtype=f32, device=G.device)
    record(rows, "pair_scatter_rows_f32", out, ref,
           (lambda: sk.pair_scatter_rows(*k4_args), 20),
           timed(lambda: sk.pair_scatter_rows_plain(*k4_args), 5),
           (G.numel() + disp.numel() + C * A * 3 * T * W + C * 6 * T * W)
           * 4 + smask.numel() + rev.numel() * 4 + types.numel() * 4,
           npairs * W * (3 * 2 + 6 * 2), None,
           wrapper="pair_scatter_rows_f32", fp32=True,
           library=lambda: scat.index_add_(0, dest, g_rows))
    del G, g_rows, scat, out, ref

    # K5, the whole ZBL reference, on the float32 lists
    zc = calc.refspec.zbl
    table = zbl_table(zc, disp.device, f32)
    k5_args = (disp, jidx, mask, rev, types, table, zc.cut_inner,
               zc.cut_outer)
    out, again = sk.zbl_eav(*k5_args), sk.zbl_eav(*k5_args)
    ref = sk.zbl_eav_plain(*k5_args)
    check32("zbl_eav_f32", out)
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        raise AssertionError("zbl_eav_f32: two calls differ")
    nlisted = int(mask.sum().item())
    record(rows, "zbl_eav_f32", out, ref, (lambda: sk.zbl_eav(*k5_args), 20),
           timed(lambda: sk.zbl_eav_plain(*k5_args), 5),
           disp.numel() * 4 + (jidx.numel() + rev.numel() + types.numel())
           * 4 + mask.numel() + table.numel() * 4 + (C + C * A * 3 + C * 6)
           * 4, 2 * nlisted * (4 * EXP_OPS + 40), None,
           wrapper="zbl_eav_f32", fp32=True)

    # K7 on the chunk's float32 rows, with the batch's float32 truths and
    # weights: direct (AtA, Atb float64) and residual (A^T r float32)
    rows_in = snap_rows(calc.params, T, calc.refspec, disp, jidx, mask, rev,
                        types, nat32, cell)
    check32("the float32 rows", list(rows_in.values()))
    truths, weights = batch[7:10], batch[10:13]
    k7_args = (rows_in, truths, weights, nat32, types, T, True, FLAGS)
    out = sk.normal_contrib(*k7_args)
    ref = sk.normal_contrib_plain(*k7_args)
    Wf = ref[1].shape[0]
    coeff = torch.linspace(-1.0, 1.0, Wf, dtype=torch.float64,
                           device=types.device)
    res = sk.normal_contrib(*k7_args, coeff, False)
    res_ref = sk.normal_contrib_plain(*k7_args, coeff, False)
    _, res_err = rel_err(res[1:2], res_ref[1:2])
    print(f"normal_contrib_f32 (width {Wf}): residual mode max_rel_err="
          f"{res_err:.3e}", flush=True)
    if not (out[0].dtype == out[1].dtype == torch.float64
            and res[1].dtype == f32 and res_err <= KERNEL_RTOL32
            and out[2].item() == ref[2].item()):
        raise AssertionError(f"normal_contrib_f32: output types "
                             f"{out[0].dtype} {out[1].dtype} {res[1].dtype}"
                             f", residual {res_err:.3e} or nrows differ")
    a_full, _ = sk.full_rows(rows_in, truths, nat32, types, T, True)
    wrow = sk.row_weights(weights, nat32, A, FLAGS)
    aw = (a_full.double() * wrow.double()[..., None]).reshape(-1, Wf)
    record(rows, "normal_contrib_f32", out[:2], ref[:2],
           (lambda: sk.normal_contrib(*k7_args), 20),
           timed(lambda: sk.normal_contrib_plain(*k7_args), 5),
           C * (1 + 3 * A + 6) * (Wf - T) * 4 + 3 * C * (1 + 3 * A + 6) * 4
           + 3 * C * 4 + C * 4 + C * A * 4 + (Wf * Wf + Wf + 1) * 8,
           aw.shape[0] * (Wf * (Wf + 1) + 2 * Wf), None,
           wrapper="normal_contrib_f32", fp32=True,
           library=lambda: torch.mm(aw.T, aw))
    rows[-1]["residual_max_rel_err"] = res_err
    del out, ref, res, res_ref, a_full, aw, rows_in
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rows


def streamed_f32_phase(fs, a_plain, beta, seed, device, keep, checks64):
    """Phase 22: phase 5's streamed fit on the same Ta-shaped set, packed
    at float32 (`pack_batch_pos(..., dtype=np.float32)`: hi/lo float32
    positions), launch counts set to 0 just before and read after the
    refined fit and the evaluation: every kernel of the path launched in its
    float32 instantiation and none at float64 (K8r, integers only, as
    phase 5's).  nrows must equal phase 5's, AtA and Atb phase 5's float64
    ones to NORMAL_RTOL32 of their largest magnitude, the refined float32
    fit beta_true within 100 cond(w A) 2^-23 and BETA_RTOL32, and the MAE
    sums phase 5's at the same coefficients (beta_true spread by
    MAE_SPREAD, seeded) to MAE_RTOL32.  Prints the device ms of a steady pass at each type, in
    turns (float64, float32, float32, float64), and the bytes of a chunk's
    disp and dB/dD at each type.  Returns (counts, timings, checks)."""
    import torch
    from fitsnap_tpu_torch.calculators.snap import chunk_size
    from fitsnap_tpu_torch.parallel import fit

    calc = fs.calculator
    reset_launches()
    t = {}
    t0 = time.time()
    packed = [calc._pack(d) for d in fs.data]
    runs = []
    for g in fit.plan_shift_groups(packed, calc.cutoff):
        per = chunk_size(g["a_pad"], g["k_pad"], calc.desc_width())
        chunks = -(-len(g["configs"]) // per)
        batch = fit.pack_batch_pos(g["configs"], g["a_pad"], chunks * per,
                                   g["s_table"], np.float32, chunks=chunks)
        runs.append(({"cutoff": calc.cutoff, "k_pad": g["k_pad"]},
                     fit.put_batch(batch, device), (per, g["a_pad"],
                                                   g["k_pad"])))
    torch.cuda.synchronize()
    t["pack_upload"] = time.time() - t0
    model = (calc.params, calc.numtypes, FLAGS, device)
    kw = {"refspec": calc.refspec}
    steps = [fit.build_step_fn(*model, neighbors=nb, accumulate=True, **kw)
             for nb, _, _ in runs]
    residuals = [fit.build_residual_fn(*model, neighbors=nb, **kw)
                 for nb, _, _ in runs]
    evals = [fit.build_eval_fn(*model, neighbors=nb, **kw)
             for nb, _, _ in runs]

    def one_pass(_=None):
        acc = steps[0][1]()
        for (acc_step, _, _), (_, batch, _) in zip(steps, runs):
            acc = acc_step(acc, batch)
        return steps[0][2](acc)

    def residual(x, _=None):
        return sum(res(x, batch) for res, (_, batch, _) in
                   zip(residuals, runs))

    def evaluate(x):
        return np.sum([ev(x, batch) for ev, (_, batch, _) in
                       zip(evals, runs)], 0)

    t0 = time.time()
    AtA, Atb, nrows = one_pass()
    t["first_pass"] = time.time() - t0
    t0 = time.time()
    for _ in range(3):
        AtA, Atb, nrows = one_pass()
    t["steady_pass"] = (time.time() - t0) / 3
    t0 = time.time()
    x_ref, _, _ = fit.fit_refined(one_pass, residual, None, refine_iters=2)
    t["refine"] = time.time() - t0
    x_mae = beta * (1.0 + MAE_SPREAD * np.random.default_rng(
        seed + 22).normal(size=beta.shape))
    sums32 = evaluate(x_mae)
    torch.cuda.synchronize()
    counts = launches()

    check_launched(counts, "streamed_f32")
    wide = {k: counts[k] for k in F32_KERNELS if counts[k]}
    if wide:
        raise AssertionError(f"the float32 streamed fit launched float64 "
                             f"kernels: {wide}")
    AtA64, Atb64, nrows64 = keep["result"]
    if not nrows == nrows64 == checks64["nrows"] == a_plain.shape[0]:
        raise AssertionError(f"nrows {nrows} != phase 5's {nrows64}")
    ata_err = np.abs(AtA - AtA64).max() / np.abs(AtA64).max()
    atb_err = np.abs(Atb - Atb64).max() / np.abs(Atb64).max()
    if not (ata_err <= NORMAL_RTOL32 and atb_err <= NORMAL_RTOL32):
        raise AssertionError(f"float32 normal equations differ from phase "
                             f"5's: AtA {ata_err:.3e}, Atb {atb_err:.3e}")
    cond = checks64["cond_weighted_a_all"]
    beta_err = np.abs(x_ref - beta).max() / np.abs(beta).max()
    beta_tol = 100 * cond * EPS32
    if not (np.isfinite(x_ref).all() and beta_err <= beta_tol
            and beta_err <= BETA_RTOL32):
        raise AssertionError(f"the float32 fit misses beta_true: "
                             f"{beta_err:.3e} > {beta_tol:.3e} or "
                             f"{BETA_RTOL32} (cond {cond:.3e})")
    sums64 = keep["evaluate"](x_mae)
    mae_err = max(abs(sums32[0] - sums64[0]) / sums64[0],
                  abs(sums32[2] - sums64[2]) / sums64[2])
    if not (sums32[1] == sums64[1] and sums32[3] == sums64[3]
            and mae_err <= MAE_RTOL32):
        raise AssertionError(f"float32 MAE sums {list(sums32)} differ from "
                             f"phase 5's {list(sums64)}")
    se, ne, sf, nf = evaluate(x_ref)
    checks = {"nrows": nrows, "ata_rel_err": float(ata_err),
              "atb_rel_err": float(atb_err), "cond_weighted_a_all": cond,
              "beta_refined_rel_err": float(beta_err),
              "beta_refined_tol": float(beta_tol),
              "beta_refined_rtol": BETA_RTOL32,
              "mae_sums_rel_err": float(mae_err),
              "energy_mae": float(se / ne), "force_mae": float(sf / nf)}

    # a steady pass at each type, in turns, by device time
    passes = {"float64": [], "float32": []}
    for tag, fn in (("float64", keep["one_pass"]), ("float32", one_pass),
                    ("float32", one_pass), ("float64", keep["one_pass"])):
        kernel_ms = profile_kernels(fn)
        passes[tag].append(sum(kernel_ms.values()) if kernel_ms else None)
        if tag == "float32" and kernel_ms:
            split32 = kernel_ms
    print(f"{card_line()}: steady streamed pass device ms (float64, "
          f"float32, float32, float64 in turns): float64 "
          f"{passes['float64']} float32 {passes['float32']}", flush=True)
    read = [x for x in passes["float32"] if x is not None]
    if read:
        print("streamed pass (float32) device time by kernel (ms): "
              + json.dumps({k: round(v, 4) for k, v in split32.items()}),
              flush=True)
        t["device_ms_per_pass"] = read[-1]
        t["device_busy_share"] = read[-1] / 1e3 / t["steady_pass"]
    checks["pass_device_ms"] = passes
    W = calc.params.nb_base
    per, a_pad, k_pad = max((r[2] for r in runs), key=lambda r: r[0] * r[1])
    chunk = {}
    for tag, item in (("float64", 8), ("float32", 4)):
        chunk[tag] = {"disp": per * a_pad * k_pad * 3 * item,
                      "dBdD": per * a_pad * W * k_pad * 3 * item}
    print(f"a chunk of {per} x {a_pad} x {k_pad} (width {W}): bytes of "
          f"disp and dB/dD " + json.dumps(chunk), flush=True)
    checks["chunk_bytes"] = chunk
    return counts, t, checks


# ---------------------------------------------------------------------------
# NN path (precompute mode)
# ---------------------------------------------------------------------------


def nn_path(tmp, device, mode="precompute", dtype=None):
    """Drive the NN fit through FitSnap on the card on the Ta set of phase
    2 in `mode` (precompute, cached, otf, otf_quadratic: quadraticflag, or
    custom: the pairwise NN), on the InP-shaped set of phase 9
    (otf_chem), nonlinear ACE on the ACE set of phase 6 (ace:
    precompute, ace_otf: OTF), or a PAS fit of `PAS_SETS[mode]` (pas_chem,
    pas, pas_ace); `dtype` "float32" (phase 23, cached and otf) passes
    `--dtype float32`; returns (the FitSnap, launch counts, timings,
    checks)."""
    import torch
    from fitsnap_tpu_torch import FitSnap
    from fitsnap_tpu_torch.tools import synthetic

    ini = Path(tmp) / f"nn_{mode}.in"
    data = Path(tmp) / "JSON"
    files = (CUSTOM_FILES if mode == "custom" else
             INP_NN_FILES if mode == "otf_chem" else
             ACE_NN_FILES if mode.startswith("ace") else NN_FILES)
    if mode in PAS_SETS:
        folder, base, name = PAS_SETS[mode]
        settings = synthetic.pas_settings(Path(tmp) / folder,
                                          getattr(synthetic, base))
        files = [f"{name}.pt", f"{name}_metrics.md", "loss_vs_epochs.dat"]
    elif mode == "custom":
        settings = synthetic.custom_settings(data)
    elif mode.startswith("ace"):
        settings = synthetic.ace_nn_settings(
            Path(tmp) / "ACE_JSON",
            dgrad_mode="otf" if mode == "ace_otf" else "precompute")
    elif mode == "otf_chem":
        settings = synthetic.inp_nn_settings(Path(tmp) / "INP_JSON",
                                             dgrad_mode="otf")
    else:
        settings = synthetic.nn_settings(
            data, dgrad_mode=mode.removesuffix("_quadratic"))
    if mode == "otf_quadratic":
        settings["BISPECTRUM"]["quadraticflag"] = 1
    if mode in NN_EPOCHS:
        settings["PYTORCH"]["num_epochs"] = NN_EPOCHS[mode]
    synthetic.write_ini(ini, settings)
    for name in files:
        Path(name).unlink(missing_ok=True)
    path = NN_PATH[mode] if dtype is None else NN_F32_PATH[mode]
    reset_launches()
    t0 = time.time()
    fs = FitSnap(str(ini), arglist=["--overwrite"]
                 + (["--dtype", dtype] if dtype else []), device=device)
    fs.scrape_configs()
    fs.process_configs()
    fs.perform_fit()
    fs.write_output()
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launches()
    sol = fs.solver
    p = getattr(fs.calculator, "params", None)
    if mode in PAS_SETS and p is not None and p.nchem > 1:
        # the plan has element channels: each K9 launch was in that mode
        counts["nn_ut_b_chem"], counts["nn_ut_b"] = counts["nn_ut_b"], 0
    check_launched(counts, path)
    absent = NN_ABSENT.get(mode, ()) if dtype is None else NN_F32_ABSENT
    if mode in PAS_SETS:
        absent = [k for k in counts if k not in PATH_KERNELS[NN_PATH[mode]]]
    stray = {k: counts[k] for k in absent if counts[k]}
    if stray:
        raise AssertionError(f"the {path} path launched {stray}")
    if mode in PAS_SETS:
        from fitsnap_tpu_torch.solvers.network import _BATCH_KEYS_PAS
        kept = {k for b in sol.buckets for k, v in b.items()
                if torch.is_tensor(v)}
        if not sol.pas or kept != set(_BATCH_KEYS_PAS):
            raise AssertionError(f"the PAS path (pas={sol.pas}) kept "
                                 f"{sorted(kept)} on the card")
    if mode == "cached" and (not sol.cached
                             or any("G" in b for b in sol.buckets)):
        raise AssertionError("the cached NN path stored dB/dD")
    stored = [k for b in sol.buckets for k in ("G", "disp", "ut") if k in b]
    if "otf" in mode and (stored or not sol.otf):
        raise AssertionError(f"the OTF NN path (otf={sol.otf}) stored "
                             f"{stored}")

    hist = np.array(sol.history)
    tag = mode if dtype is None else f"{mode}, {dtype}"
    print(f"nn loss curve ({tag}; epoch, train, validation): "
          + json.dumps(hist.tolist()), flush=True)
    print(f"nn seconds per epoch ({tag}): " + json.dumps(sol.epoch_times),
          flush=True)
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
              "history": hist.tolist(),
              "g_bytes": sum(b["G"].numel() * 8 for b in sol.buckets
                             if "G" in b),
              "cached_bytes": sum(b[k].numel() * b[k].element_size()
                                  for b in sol.buckets if "ut" in b
                                  for k in ("disp", "jidx", "mask", "rev",
                                            "ut", "B")),
              "pair_bytes": sum(b[k].numel() * b[k].element_size()
                                for b in sol.buckets if mode == "custom"
                                for k in ("disp", "jidx", "mask", "rev")),
              "position_bytes": sum(b[k].numel() * b[k].element_size()
                                    for b in sol.buckets if "pos_hi" in b
                                    for k in ("pos_hi", "pos_lo", "svec_hi",
                                              "svec_lo")),
              "errors": {f"{g}/{t}": dict(zip(errs.columns, map(float, v)))
                         for (g, t), v in zip(errs.index, errs.values)
                         if g == "*ALL"}}
    times = dict(fs.timings, wall=wall,
                 epoch_first=sol.epoch_times[0],
                 epoch_mean_rest=float(np.mean(sol.epoch_times[1:])))
    return fs, counts, times, checks


def nn_batch(sol, n=4, pick=np.argmax):
    """A minibatch of the first n configs of the largest bucket
    (pick=np.argmin: the smallest), with the trained model's dE/dB (K12's
    input)."""
    import torch

    bi = int(pick([np.prod(b["shape"]) for b in sol.buckets]))
    batch = sol._gather(sol.buckets[bi],
                        np.arange(min(n, len(sol.buckets[bi]["groups"]))))
    x = ((batch["B"] - sol.mean) / sol.std).requires_grad_(True)
    e = (sol.model(x, batch["types"]) * batch["real"].to(x.dtype)).sum()
    dEdB = (torch.autograd.grad(e, x)[0] / sol.std).contiguous()
    return batch, dEdB


def k12_row(rows, args, out, ref, shape=None):
    """K12's row on (dE/dB, G, jidx, rev): timed on rotating copies of the
    inputs, so that G comes from HBM as the bound assumes, and on one
    repeated input (`device_ms_l2`, which L2 holds, as it holds a minibatch
    just gathered in training); `contraction_device_ms` is the contraction's
    kernel alone (the row's device ms adds the gather's); the library call
    is `torch.bmm` of the contraction alone, timed the same two ways."""
    import torch
    from fitsnap_tpu_torch.kernels import nn_kernels as nk

    dEdB, G, jidx, rev = args
    N, A, W, K, _ = G.shape
    R = rev.shape[2]

    def bmm(d, g):
        return torch.bmm(d.view(N * A, 1, W), g.view(N * A, W, 3 * K))

    record(rows, "nn_force" + (f"@{shape}" if shape else ""), [out], [ref],
           (rotating(nk.nn_force, args), 20),
           timed(rotating(nk.nn_force_plain, args), 10),
           G.numel() * 8 + dEdB.numel() * 8 + rev.numel() * 4 + N * A * 3 * 8,
           2 * G.numel() + N * A * (K + R) * 3, None, wrapper="nn_force",
           shape=shape, library=rotating(bmm, (dEdB, G)))
    row = rows[-1]
    row["device_ms_l2"] = device_time(lambda: nk.nn_force(*args), 20)
    fn = rotating(nk.nn_force, args)
    fn()
    split = profile_kernels(lambda: [fn() for _ in range(20)])
    row["contraction_device_ms"] = (
        split.get("nn_fpair_kernel", 0.0) / 20 if split else None)
    row["library_device_ms_l2"] = device_time(lambda: bmm(dEdB, G), 20)
    print(f"{row['name']}: contraction device_ms="
          f"{row['contraction_device_ms']} device_ms_l2="
          f"{row['device_ms_l2']} torch.bmm device_ms="
          f"{row['library_device_ms']} (L2: {row['library_device_ms_l2']})",
          flush=True)


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
    the largest bucket (K12 also at the smallest), and the loss gradient
    through NnForce against autograd through K12's plain version."""
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
    # K12 at this minibatch and at the smallest bucket's, K12T, each timed
    # on rotating copies of the inputs (from HBM) and on one repeated input
    # (from L2)
    rows = []
    args = (dEdB, G, jidx, rev)
    out = nk.nn_force(*args)
    ref = nk.nn_force_plain(*args)
    k12_row(rows, args, out, ref)

    def seeded(t, rng):
        return torch.as_tensor(rng.normal(size=tuple(t.shape)),
                               device=t.device)

    # the digest on seeded dE/dB and G (the trained dE/dB differs from run
    # to run of one build)
    rng = np.random.default_rng(12)
    DIGESTS["nn_force (NN minibatch, seeded dE/dB and G)"] = digest(
        [nk.nn_force(seeded(dEdB, rng), seeded(G, rng), jidx, rev)])
    # the smallest bucket's cells are perfect lattices, whose forces cancel
    # to rounding for any dE/dB: seeded dE/dB and G on its lists
    small, dEdB_small = nn_batch(sol, pick=np.argmin)
    targs = (dEdB_small, small["G"], small["jidx"], small["rev"])
    t_abs, t_rel = rel_err([nk.nn_force(*targs)], [nk.nn_force_plain(*targs)])
    print(f"nn_force at the smallest bucket on its trained dE/dB and G "
          f"(context, not held to 1e-11): max |plain| "
          f"{nk.nn_force_plain(*targs).abs().max().item():.3e}, max abs "
          f"error {t_abs:.3e}, relative {t_rel:.3e}", flush=True)
    rng = np.random.default_rng(16)
    sargs = (seeded(dEdB_small, rng), seeded(small["G"], rng),
             small["jidx"], small["rev"])
    print(f"nn kernel inputs, the smallest bucket: "
          f"{list(small['G'].shape)}, seeded dE/dB and G", flush=True)
    k12_row(rows, sargs, nk.nn_force(*sargs), nk.nn_force_plain(*sargs),
            shape=list(small["G"].shape[:2]) + [small["G"].shape[3]])
    gF = ((ref - batch["f_target"])
          * batch["real"][..., None].to(ref.dtype)).contiguous()
    g_bytes = G.numel() * 8
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


def fd_check(fs, evaluate, tag, groups=("Displaced_BCC", "Liquid")):
    """Central-difference forces of the trained model against its forces,
    `evaluate(sol, calc, pos, cell, types)` -> (energy, forces), on three
    atoms of the first config of each group (the Ta set's: a displaced
    54-atom bcc cell and a 100-atom liquid-like one)."""
    sol, calc = fs.solver, fs.calculator
    worst = []
    for group in groups:
        d = [x for x in fs.data if x["Group"] == group][0]
        pos = np.asarray(d["Positions"], float)
        cell = np.asarray(d["Lattice"], float)
        types = [calc.type_mapping[t] - 1 for t in d["AtomTypes"]]
        _, f0 = evaluate(sol, calc, pos, cell, types)
        for a in (0, len(pos) // 2, len(pos) - 1):
            for c in range(3):
                pp, pm = pos.copy(), pos.copy()
                pp[a, c] += FD_H
                pm[a, c] -= FD_H
                ep, _ = evaluate(sol, calc, pp, cell, types)
                em, _ = evaluate(sol, calc, pm, cell, types)
                worst.append(abs(-(ep - em) / (2 * FD_H) - f0[a, c]))
    err = float(np.max(worst))
    print(f"{tag} FD forces (h={FD_H}): max error {err:.3e}, mean "
          f"{float(np.mean(worst)):.3e} (bar {FD_BAR})", flush=True)
    if not err < FD_BAR:
        raise AssertionError(f"{tag} FD forces miss the bar: {err:.3e}")
    return {"fd_max_err": err, "fd_mean_err": float(np.mean(worst)),
            "fd_bar": FD_BAR}


def nn_export_check(fs, path="Ta_nn.pt", B=None):
    """The written .pt's per-atom energies on one config against the
    model's and evaluate_bucket's (B: that config's descriptors where its
    bucket keeps none, as in the OTF mode)."""
    import torch

    sol = fs.solver
    ds = sol.buckets[-1]
    nat = int(ds["nat_host"][0])
    B = ds["B"][0, :nat] if B is None else B
    model = torch.load(path, weights_only=False)
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
    and the gather; OTF: also K8, K8r and K9, or under chemflag K8, K8r,
    K1-K3's chemflag modes, K12 / K12T; pairwise: K15, K15V, K15T and the
    gather), the other
    kernels (MLP, its double backward, gathers,
    Adam), and its share of `epoch_s`, the unprofiled epoch's seconds;
    prints each port kernel's launches in the epoch beside its device ms."""
    net = fs.solver.net
    epochs = net.num_epochs
    net.num_epochs = 1
    reset_launches()
    try:
        kernels = profile_kernels(lambda: fs.solver.perform_fit())
    finally:
        net.num_epochs = epochs
    counts = {k: v for k, v in launches().items() if v}
    if not kernels:
        return {"epoch_profile": "not measured (no device time)",
                "epoch_launches": counts}
    ours = sum(v for k, v in kernels.items()
               if k.startswith(("nn_", "zlist", "pair_desc", "neighbors_",
                                "reverse_", "pair_u_duals", "dbdd", "ace_")))
    total = sum(kernels.values())
    print("nn epoch device time by kernel (ms): " + json.dumps(
        {k: round(v, 3) for k, v in list(kernels.items())[:12]}),
        flush=True)
    port = {k: {"launches": n,
                "device_ms": kernels.get(KERNEL_FN.get(k, f"{k}_kernel"))}
            for k, n in counts.items()}
    print("nn epoch port kernels (launches, device ms): " + json.dumps(port),
          flush=True)
    return {"epoch_device_ms": total, "epoch_port_kernels_ms": ours,
            "epoch_other_kernels_ms": total - ours,
            "device_busy_share": total / 1e3 / epoch_s,
            "epoch_port_kernels": port}


def nn_cached_batch(sol, n=4, pick=np.argmax):
    """A minibatch of the first n configs of the cached mode's largest
    bucket (pick=np.argmin: its smallest), with the trained model's dE/dB
    (N*A, W) and the pair-kernel inputs flat over the (N*A) atoms."""
    import torch

    bi = int(pick([np.prod(b["shape"]) for b in sol.buckets]))
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


def digest(tensors):
    """First 16 hex digits of the sha256 of tensors' bytes: equal digests
    mean equal outputs, bit for bit."""
    import hashlib

    return hashlib.sha256(b"".join(t.cpu().numpy().tobytes()
                                   for t in tensors)).hexdigest()[:16]


def gather_row(rows, g, rev, jidx, mask, tag=""):
    """The force gather against its plain version on pair gradients g (N,
    A, K, 3) with the reverse table rev and the lists jidx, mask (N, A, K),
    timed on rotating copies, beside `index_add_` of the neighbor scatter
    alone as its library call; also prints, as context, the whole gather in
    PyTorch: g.sum(2), then `index_add_` of the scatter (two calls)."""
    import torch
    from fitsnap_tpu_torch.kernels import nn_kernels as nk

    N, A, K, _ = g.shape
    args = (g, rev)
    F = nk.nn_pair_gather_plain(*args)
    # index_add_ of the neighbor scatter into (N A, 3), as K4's rows have it
    dest = (torch.arange(N, device=g.device)[:, None, None] * A
            + jidx.long())[mask]
    scat = torch.zeros((N * A, 3), dtype=g.dtype, device=g.device)
    # one add per slot and component
    record(rows, "nn_pair_gather" + tag, [nk.nn_pair_gather(*args)], [F],
           (rotating(nk.nn_pair_gather, args), 20),
           timed(rotating(nk.nn_pair_gather_plain, args), 10),
           N * A * K * 3 * 8 + rev.numel() * 4 + N * A * 3 * 8,
           N * A * 3 * (K + rev.shape[2]), None, wrapper="nn_pair_gather",
           shape=[N, A, K],
           library=rotating(lambda d, gr: scat.index_add_(0, d, gr),
                            (dest, g[mask])))

    def whole(gg, d, gr):
        return gg.sum(2).reshape(N * A, 3).index_add_(0, d, gr, alpha=-1.0)

    err = rel_err([whole(g, dest, g[mask]).reshape(N, A, 3)], [F])[1]
    call = rotating(whole, (g, dest, g[mask]))
    print(f"nn_pair_gather{tag} in PyTorch (g.sum(2), then index_add_; two "
          f"calls): ms={timed(call, 20):.4f} device_ms="
          f"{device_time(call, 20)} max_rel_err={err:.3e}", flush=True)


def referenced_z(tb):
    """The number of z entries the y tables reference (of each atom's nz):
    what K10 and K10T must read."""
    return tb.yz_src.numel()


def k9_row(rows, block, p, tag="", shape=None):
    """K9 against its plain version on `block`'s atoms (1e-11), two calls
    bit for bit with the digest kept; returns the plain (ut, B).  Its bound:
    the pair inputs read once, ut and B written once; per live pair the
    prologue's values (sqrt, tan, rsqrt and a cosine, EXP_OPS each, and
    about 20 more), the four power tables, w T1, T1 and T2 (3 n_t) and the
    grid's rank-one update (2 n_t^2, in its channel's grid), per atom 2 per
    Lg entry in each channel (ut) and 12 per B term (over the nchem^3
    channel triples).  A plan with element channels makes the row of K9's
    channel mode ("nn_ut_b_chem")."""
    import torch
    from fitsnap_tpu_torch.kernels import nn_kernels as nk
    from fitsnap_tpu_torch.ops.snap import nn_tables

    tb = nn_tables(p)
    M, K = block[2].shape
    n_t, U, W = tb.n_t, p.nchem * p.u_len, p.nb_base
    pairs = int(block[2].sum().item())
    name = "nn_ut_b" + tag
    out, again = nk.nn_ut_b(*block, p), nk.nn_ut_b(*block, p)
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        raise AssertionError(f"{name}: two calls differ")
    DIGESTS[name] = digest(out)
    ref = nk.nn_ut_b_plain(*block, p)
    print(f"{name}: atoms={M} K={K} live pairs={pairs}", flush=True)
    record(rows, name, list(out), list(ref),
           (rotating(lambda *a: nk.nn_ut_b(*a, p), block), 20),
           timed(rotating(lambda *a: nk.nn_ut_b_plain(*a, p), block), 5),
           M * K * (3 * 8 + 4 + 1) + M * 4 + M * (2 * U + W) * 8,
           pairs * (2 * n_t * n_t + 3 * n_t + 4 * (p.twojmax + 1)
                    + 4 * EXP_OPS + 20)
           + M * (2 * p.nchem * tb.lgc_val.numel() + 12 * len(tb.bt_c)),
           None, wrapper="nn_ut_b_chem" if p.nchem > 1 else "nn_ut_b",
           shape=shape, vector=True)
    return ref


def k10_row(rows, dEdB, z, p, tag="", shape=None):
    """K10 against its plain version on dE/dB and the z-lists (1e-11), two
    calls bit for bit, with the digest kept on a seeded dE/dB (training
    need not repeat bit for bit); returns the plain vg.  Its bound: dE/dB
    and the z entries the y tables reference read once, vg written once;
    5 flops per y entry and 2 per Lg entry, per atom."""
    import torch
    from fitsnap_tpu_torch.kernels import nn_kernels as nk
    from fitsnap_tpu_torch.ops.snap import nn_tables

    tb = nn_tables(p)
    M, W, n_t = dEdB.shape[0], p.ntriples, tb.n_t
    args = (dEdB,) + tuple(z)
    name = "nn_dedu_vg" + tag
    out, again = nk.nn_dedu_vg(*args, p), nk.nn_dedu_vg(*args, p)
    if not torch.equal(out, again):
        raise AssertionError(f"{name}: two calls differ")
    seeded = torch.as_tensor(np.random.default_rng(0).normal(
        size=tuple(dEdB.shape)), device=dEdB.device)
    DIGESTS[name + " (seeded dE/dB)"] = digest(
        [nk.nn_dedu_vg(seeded, *z, p)])
    ref = nk.nn_dedu_vg_plain(*args, p)
    record(rows, name, [out], [ref],
           (rotating(lambda *a: nk.nn_dedu_vg(*a, p), args), 20),
           timed(rotating(lambda *a: nk.nn_dedu_vg_plain(*a, p), args), 5),
           M * (W + 2 * referenced_z(tb) + n_t * n_t) * 8,
           M * (5 * len(tb.yu_fac) + 2 * tb.lgr_val.numel()), None,
           wrapper="nn_dedu_vg", shape=shape, vector=True)
    return ref


def cached_small_rows(rows, sol):
    """K9, K10, K11, K11T and K10T against their plain versions on a
    minibatch of 4 at the cached mode's smallest bucket: K9 on its lists,
    K10 on the trained dE/dB, K11 on the plain K10's grid cotangent, K11T
    on the force residual of the plain forward, K10T on the plain K11T's
    grid cotangent."""
    import torch
    from fitsnap_tpu_torch.kernels import nn_kernels as nk
    from fitsnap_tpu_torch.kernels import snap_kernels as sk
    from fitsnap_tpu_torch.ops.snap import nn_tables

    p = sol._snap
    tb = nn_tables(p)
    n_t, W = tb.n_t, p.ntriples
    batch, dEdB, block = nn_cached_batch(sol, pick=np.argmin)
    N, A, K = batch["jidx"].shape
    M = N * A
    z = sk.zlist_plain(batch["ut"].reshape(M, -1), p)
    pairs = int(block[2].sum().item())
    pair_in = M * K * (3 * 8 + 4 + 1) + M * 4
    print(f"nn cached smallest bucket: N={N} A={A} K={K} live pairs={pairs}",
          flush=True)
    k9_row(rows, block, p, f"@{(A, K)}", [N, A, K])
    vg = k10_row(rows, dEdB, z, p, f"@{(A, K)}", [N, A, K])
    args = (vg,) + block
    g = nk.nn_pair_force_plain(*args, p)
    record(rows, f"nn_pair_force@{(A, K)}", [nk.nn_pair_force(*args, p)], [g],
           (rotating(lambda *a: nk.nn_pair_force(*a, p), args), 20),
           timed(rotating(lambda *a: nk.nn_pair_force_plain(*a, p), args), 5),
           pair_in + M * n_t * n_t * 8 + M * K * 3 * 8,
           pairs * (8 * n_t * n_t + 600), None, wrapper="nn_pair_force",
           shape=[N, A, K], vector=True)
    F = nk.nn_pair_gather_plain(g.reshape(N, A, K, 3), batch["rev"])
    gF = ((F - batch["f_target"])
          * batch["real"][..., None].to(F.dtype)).contiguous()
    args = (gF, batch["jidx"]) + block
    vgc = nk.nn_pair_force_t_plain(*args, p)
    record(rows, f"nn_pair_force_t@{(A, K)}", [nk.nn_pair_force_t(*args, p)],
           [vgc], (rotating(lambda *a: nk.nn_pair_force_t(*a, p), args), 20),
           timed(rotating(lambda *a: nk.nn_pair_force_t_plain(*a, p), args),
                 5),
           M * 3 * 8 + M * K * 4 + pair_in + M * n_t * n_t * 8,
           pairs * (4 * n_t * n_t + 600), None, wrapper="nn_pair_force_t",
           shape=[N, A, K], vector=True)
    args = (vgc,) + tuple(z)
    record(rows, f"nn_dedu_vg_t@{(A, K)}", [nk.nn_dedu_vg_t(*args, p)],
           [nk.nn_dedu_vg_t_plain(*args, p)],
           (rotating(lambda *a: nk.nn_dedu_vg_t(*a, p), args), 20),
           timed(rotating(lambda *a: nk.nn_dedu_vg_t_plain(*a, p), args), 5),
           M * (n_t * n_t + 2 * referenced_z(tb) + W) * 8,
           M * (2 * tb.lgc_val.numel() + 5 * len(tb.yu_fac)), None,
           wrapper="nn_dedu_vg_t", shape=[N, A, K], vector=True)


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
    nlg, ny = tb.lgc_val.numel(), len(tb.yu_fac)
    pair_in = M * K * (3 * 8 + 4 + 1) + M * 4        # disp, jelem, mask, ielem
    rows = []

    def lg_mm(x, transpose=False):
        """torch.mm with the dense Lg: the basis change alone, as the
        yardstick of one library call (no one call computes a whole
        kernel's function)."""
        Lg = tb.Lg2.T.contiguous() if transpose else tb.Lg2
        return timed(rotating(lambda y: torch.mm(y, Lg), (x,)), 20)

    # K9 at the minibatch and at the cached prep's chunk (`PREP_CHUNK`
    # configs of the largest bucket, where its launches of a fit run)
    ut, _ = k9_row(rows, block, p)
    rows[-1]["lg_mm_ms"] = lg_mm(torch.zeros((M, n_t * n_t),
                                             dtype=torch.float64,
                                             device=ut.device) + 1.0)
    prep, _, prep_block = nn_cached_batch(sol, n=PREP_CHUNK)
    print(f"nn cached prep chunk: C={prep['jidx'].shape[0]} "
          f"A={A} K={K}", flush=True)
    k9_row(rows, prep_block, p, "@prep", list(prep["jidx"].shape))
    del prep, prep_block
    z = sk.zlist(batch["ut"].reshape(M, -1), p)

    # K10 (its bytes, as K10T's, count the z entries the y tables
    # reference)
    nzr = referenced_z(tb)
    vg = k10_row(rows, dEdB, z, p)
    rows[-1]["lg_mm_ms"] = lg_mm(torch.ones((M, 2 * U), dtype=torch.float64,
                                            device=vg.device), True)

    # K11: per live pair 8 n_t^2 flops (four bilinear forms) and 600
    args = (vg,) + block
    g = nk.nn_pair_force_plain(*args, p)
    record(rows, "nn_pair_force", [nk.nn_pair_force(*args, p)], [g],
           (rotating(lambda *a: nk.nn_pair_force(*a, p), args), 20),
           timed(rotating(lambda *a: nk.nn_pair_force_plain(*a, p), args), 5),
           pair_in + M * n_t * n_t * 8 + M * K * 3 * 8,
           pairs * (8 * n_t * n_t + 600), None, vector=True)

    # the gather, on K11's pair gradients
    F = nk.nn_pair_gather_plain(g.reshape(N, A, K, 3), rev)
    gather_row(rows, g.reshape(N, A, K, 3), rev, batch["jidx"], batch["mask"])
    # K9's, K11's and K11T's outputs (K11 on a seeded vg, K11T on a seeded
    # gF, which training does not touch), to compare builds bit for bit
    rng = np.random.default_rng(0)
    vg_seeded = torch.as_tensor(rng.normal(size=(M, n_t, n_t)),
                                device=vg.device)
    gF_seeded = torch.as_tensor(rng.normal(size=(N, A, 3)), device=vg.device)
    k11t_seeded = nk.nn_pair_force_t(gF_seeded, batch["jidx"], *block, p)
    print(f"nn_pair_force outputs' digest (seeded vg): "
          f"{digest([nk.nn_pair_force(vg_seeded, *block, p)])}; "
          f"nn_pair_force_t outputs' digest (seeded gF): "
          f"{digest([k11t_seeded])}; " + "; ".join(
              f"{k} outputs' digest: {v}" for k, v in DIGESTS.items()),
          flush=True)

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
           pairs * (4 * n_t * n_t + 600), None, wrapper="nn_pair_force_t",
           shape=[N, A, K], vector=True)
    cached_small_rows(rows, sol)

    # K10T: 2 flops per Lg entry, 5 per y entry, per atom
    args = (vgc,) + tuple(z)
    ref = nk.nn_dedu_vg_t_plain(*args, p)
    record(rows, "nn_dedu_vg_t", [nk.nn_dedu_vg_t(*args, p)], [ref],
           (rotating(lambda *a: nk.nn_dedu_vg_t(*a, p), args), 20),
           timed(rotating(lambda *a: nk.nn_dedu_vg_t_plain(*a, p), args), 5),
           M * (n_t * n_t + 2 * nzr + W) * 8, M * (2 * nlg + 5 * ny), None,
           vector=True)
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


def otf_lists(sol, batch):
    """The lists an OTF step builds for `batch`: K8, then K8r."""
    from fitsnap_tpu_torch.kernels import snap_kernels as sk

    disp, jidx, mask = sk.device_neighbors(
        batch["pos_hi"], batch["pos_lo"], batch["svec_hi"], batch["svec_lo"],
        batch["nat"], sol._cutoff, batch["shape"][1])
    return disp, jidx, mask, sk.reverse_table(jidx, mask)[0]


def nn_otf_cross_check(fs):
    """The trained OTF model's energies and forces on a minibatch of 4 (the
    largest bucket) against the precompute path's on the lists the step
    builds (B and dB/dD from K1-K3, their chemflag modes and K6q under
    their flags, or for ACE K13 and K14, then K12) and, for linear SNAP,
    the cached step's on them (K9's ut and B, then K2, K10, K11 and the
    gather)."""
    sol, calc = fs.solver, fs.calculator
    bi = int(np.argmax([np.prod(b["shape"]) for b in sol.buckets]))
    batch = sol._gather(sol.buckets[bi],
                        np.arange(min(4, len(sol.buckets[bi]["groups"]))))
    e, f = sol._forward_batch_otf(sol.model, batch)
    disp, jidx, mask, rev = otf_lists(sol, batch)
    types, nat = batch["types"], batch["nat"]
    B, G, _, _ = calc.nn_prep(disp, jidx, mask, rev, types, nat)
    e_ref, f_ref = sol._forward_batch(sol.model, dict(
        batch, B=B, G=G, types=batch["elem"], jidx=jidx, rev=rev))
    out = {"otf_vs_precompute_rel_err": rel_err([e, f], [e_ref, f_ref])[1]}
    p = getattr(calc, "params", None)       # None: ACE
    if p is not None and not (p.chemflag or p.quadraticflag):
        ut, Bc = sol._kit["utb"](disp, jidx, mask, types, nat)
        e_ref, f_ref = sol._forward_batch_cached(sol.model, dict(
            batch, disp=disp, jidx=jidx, mask=mask, rev=rev, ut=ut, B=Bc))
        out["otf_vs_cached_rel_err"] = rel_err([e, f], [e_ref, f_ref])[1]
    print(f"nn OTF vs the other modes on one minibatch "
          f"({list(batch['pos_hi'].shape[:2])}): energies and forces "
          f"{json.dumps(out)} (limit {CROSS_RTOL})", flush=True)
    if not all(v <= CROSS_RTOL for v in out.values()):
        raise AssertionError(f"NN OTF and the other modes disagree: {out}")
    return out


def nn_otf_eval(sol, calc, pos, cell, types):
    """Energy and OTF forces of one config: its positions packed as an OTF
    bucket's (`pack_batch_pos`), then the OTF step's forward (K8, K8r and
    its route's kernels)."""
    import torch
    from fitsnap_tpu_torch.calculators.snap import PackedConfig
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
    batch = {"pos_hi": ph, "pos_lo": pl, "svec_hi": sh, "svec_lo": sl,
             "types": t, "elem": torch.zeros_like(t),
             "real": torch.ones_like(t, dtype=torch.bool), "nat": nat,
             "shape": (n, k_pad)}
    e, f = sol._forward_batch_otf(sol.model, batch)
    return float(e[0]) * n, f[0].cpu().numpy()


@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper replaced by its plain version (in its module and
    where the NN solver imported it by name) while the block runs: the
    plain path on the card, the reference of the NN phases' loss curves."""
    from fitsnap_tpu_torch.kernels import ace_kernels as ak
    from fitsnap_tpu_torch.kernels import custom_kernels as ck
    from fitsnap_tpu_torch.kernels import nn_kernels as nk
    from fitsnap_tpu_torch.kernels import snap_kernels as sk
    from fitsnap_tpu_torch.solvers import network as tnet

    saved = []
    for mod in (sk, ak, nk, ck):
        for k in mod.KERNELS:
            # the chemflag modes share their one-channel wrapper's twin
            plain = getattr(mod, k.__name__.removesuffix("_chem") + "_plain")
            for owner in (mod, tnet):
                if getattr(owner, k.__name__, None) is k:
                    saved.append((owner, k.__name__, k))
                    setattr(owner, k.__name__, plain)
    try:
        yield
    finally:
        for owner, name, k in saved:
            setattr(owner, name, k)


def ace_nn_eval(sol, calc, pos, cell, types):
    """Energy and K12 forces of one config through the nonlinear ACE
    precompute pipeline: host lists, then K13, K14 and the MLP on the
    card."""
    import torch
    from fitsnap_tpu_torch.calculators.ace import ace_batch
    from fitsnap_tpu_torch.ops.neighbors import (host_neighbors,
                                                 reverse_neighbors)

    n = len(pos)
    disp, jidx, mask, _ = host_neighbors(pos, cell, n, calc.cutoff)
    rev = reverse_neighbors(jidx, mask, n)

    def put(x):
        return torch.as_tensor(x, device=calc.device)[None]

    types = put(np.asarray(types, np.int32))
    nat = torch.tensor([n], device=calc.device)
    B, G, _ = ace_batch(calc.plan, put(disp), put(jidx), put(mask), types,
                        nat)
    batch = {"B": B, "G": G, "types": torch.zeros_like(types),
             "real": torch.ones((1, n), dtype=torch.bool,
                                device=calc.device),
             "nat": nat, "jidx": put(jidx), "rev": put(rev)}
    e, f = sol._forward_batch(sol.model, batch)
    return float(e[0]) * n, f[0].cpu().numpy()


def ace_nn_checks(fs, tmp, mode, epoch_s):
    """Nonlinear ACE after its fit (mode "ace": precompute, "ace_otf"):
    the .pt against the model; OTF: the trained model's forces on a
    minibatch against the precompute path's (K13 and K14 on the step's
    lists, then K12), 1e-9; central-difference forces (1e-5); the same fit
    through FitSnap with every kernel's plain version on the card
    (`plain_kernels`), its loss curve held to the kernels' to 1e-10; a
    profiler split of one epoch (which trains anew: last)."""
    sol, calc = fs.solver, fs.calculator
    out = {"labels": len(calc.plan.labels)}
    if mode == "ace_otf":
        bi = len(sol.buckets) - 1
        batch = sol._gather(sol.buckets[bi], np.arange(1))
        disp, jidx, mask, _ = otf_lists(sol, batch)
        nat = int(sol.buckets[bi]["nat_host"][0])
        B = calc.nn_desc(disp, jidx, mask, batch["types"],
                         batch["nat"])[0, :nat]
        out.update(nn_export_check(fs, "Ta_ace_nn.pt", B),
                   **nn_otf_cross_check(fs),
                   **fd_check(fs, nn_otf_eval, f"nn {mode}"))
    else:
        out.update(nn_export_check(fs, "Ta_ace_nn.pt"),
                   **fd_check(fs, ace_nn_eval, f"nn {mode}"))
    out.update(plain_fit_check(fs, tmp, mode),
               **nn_epoch_profile(fs, epoch_s))
    return out


def plain_fit_check(fs, tmp, mode):
    """The fit of `nn_path(tmp, mode)` again through FitSnap with every
    kernel's plain version on the card (`plain_kernels`): its loss curve
    held to the kernels' fit's to LOSS_RTOL."""
    import torch
    from fitsnap_tpu_torch import FitSnap

    t0 = time.time()
    with plain_kernels():
        ref = FitSnap(str(Path(tmp) / f"nn_{mode}.in"),
                      arglist=["--overwrite"], device=fs.device)
        ref.scrape_configs()
        ref.process_configs()
        ref.perform_fit()
        torch.cuda.synchronize()
    hist = np.array(fs.solver.history)
    ref_hist = np.array(ref.solver.history)
    loss_err = float(np.abs(hist - ref_hist).max()
                     / np.abs(ref_hist).max())
    print(f"nn {mode} loss curve vs the plain versions' fit on the card: "
          f"{loss_err:.3e} (limit {LOSS_RTOL}; plain fit "
          f"{time.time() - t0:.2f} s): " + json.dumps(ref_hist.tolist()),
          flush=True)
    if not loss_err <= LOSS_RTOL:
        raise AssertionError(f"nn {mode}: the loss curve differs from the "
                             f"plain versions' fit: {loss_err:.3e}")
    del ref
    torch.cuda.empty_cache()
    return {"loss_vs_plain_rel_err": loss_err}


def pas_data(tmp, seed):
    """The PAS phases' sets: the Ta-shaped configs of phase 2 and the
    InP-shaped ones of phase 9 (the same seeds) with the seeded per-atom
    `Chis` of `synthetic.with_chis`, zero energies and forces."""
    from fitsnap_tpu_torch.tools import synthetic

    synthetic.write_dataset(Path(tmp) / "PAS_JSON", synthetic.with_chis(
        synthetic.ta_configs(seed), seed + 12))
    synthetic.write_dataset(Path(tmp) / "INP_PAS_JSON", synthetic.with_chis(
        synthetic.inp_configs(seed), seed + 13))


def pas_prep_block(fs):
    """K9's inputs at one chunk of the PAS prep of the largest bucket
    (`solvers/network.py` `_prepare_pas`: `pas_chunk` configs of it, the
    host lists, then the SNAP pair mask), flat (C*A, K), and (C, A, K)."""
    import torch
    from fitsnap_tpu_torch.calculators.snap import (
        coalesce_shape_buckets, pack_bucket, pair_masks)
    from fitsnap_tpu_torch.solvers.network import pas_chunk

    calc = fs.calculator
    packed, buckets = calc.host_preprocess(fs.data)
    (a_pad, k_pad), idxs = max(coalesce_shape_buckets(buckets).items(),
                               key=lambda kv: kv[0][0] * kv[0][1])
    idxs = idxs[:pas_chunk(calc, a_pad, k_pad)]
    disp, jidx, mask, _, types, _, _ = (
        torch.from_numpy(x).to(calc.device)
        for x in pack_bucket(packed, idxs, a_pad, k_pad))
    jelem, smask = pair_masks(calc.params, disp, jidx, mask, types)
    C, A, K = mask.shape
    N = C * A
    return (disp.reshape(N, K, 3), jelem.reshape(N, K), smask.reshape(N, K),
            types.reshape(N)), [C, A, K]


def pas_export_check(fs, name):
    """The written .pt's per-atom outputs on the first config of the last
    bucket against `evaluate_bucket`'s scalars (the elements as the bucket
    holds them)."""
    import torch

    sol = fs.solver
    ds = sol.buckets[-1]
    nat = int(ds["nat_host"][0])
    B = ds["B"][0, :nat].cpu().numpy().copy()
    model = torch.load(f"{name}.pt", weights_only=False)
    beta, scal = np.zeros(B.shape), np.zeros(nat)
    model(ds["types"][0, :nat].cpu().numpy().astype(np.int32), B, beta,
          scal)
    pred, _ = sol.evaluate_bucket(ds)
    err = float(np.abs(scal - pred[0, :nat]).max()
                / np.abs(pred[0, :nat]).max())
    print(f"pas exported .pt vs evaluate_bucket: {err:.3e} (limit "
          f"{PT_RTOL})", flush=True)
    if not err <= PT_RTOL:
        raise AssertionError(f"the exported PAS .pt disagrees: {err:.3e}")
    return {"pt_rel_err": err}


def pas_checks(fs, tmp, mode, epoch_s):
    """A PAS phase after its fit: under chemflag K9's channel mode against
    its plain version at one chunk of the PAS prep (a kernel row); the .pt
    against evaluate_bucket; the same fit with every kernel's plain version
    on the card, its loss curve held to 1e-10; a profiler split of one
    epoch (which trains anew: last).  Returns (kernel rows, checks)."""
    rows = []
    p = getattr(fs.calculator, "params", None)
    if p is not None and p.nchem > 1:
        block, shape = pas_prep_block(fs)
        print(f"pas prep chunk: C={shape[0]} A={shape[1]} K={shape[2]} "
              f"channels={p.nchem} width={p.nb_base}", flush=True)
        k9_row(rows, block, p, "_chem@pas_prep", shape)
        del block
    out = {"width": int(fs.solver.mean.shape[0])}
    out.update(pas_export_check(fs, PAS_SETS[mode][2]),
               **plain_fit_check(fs, tmp, mode),
               **nn_epoch_profile(fs, epoch_s))
    return rows, out


def custom_batch(sol, n=4, shape=None):
    """A minibatch of the first n configs of the pairwise mode's bucket of
    `shape` (None: the largest), with the trained model's g_desc =
    dE/d(descriptor) and e_env, K15V's inputs as in training."""
    import torch
    from fitsnap_tpu_torch.kernels import custom_kernels as ck

    shapes = [tuple(b["shape"]) for b in sol.buckets]
    bi = (int(np.argmax([np.prod(b) for b in shapes])) if shape is None
          else shapes.index(tuple(shape)))
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


def custom_kernel_rows(rows, sol, shape=None):
    """K15, K15V and K15T against their plain versions on a minibatch of 4
    of the bucket of `shape` (None: the largest; its rows keep the
    kernels' names, another shape's are named `<kernel>@<shape>` and add
    the force gather's row).  Returns the minibatch."""
    import torch
    from fitsnap_tpu_torch.kernels import custom_kernels as ck
    from fitsnap_tpu_torch.kernels import nn_kernels as nk

    sec = sol._custom
    args3 = (sec.cutoff, sec.num_radial, sec.num_3body)
    R, M = sec.num_radial, sec.num_3body
    batch, g_desc, e_env = custom_batch(sol, shape=shape)
    disp, mask, jidx = batch["disp"], batch["mask"], batch["jidx"]
    N, A, K, _ = disp.shape
    live = mask.sum(-1).to(torch.float64)
    terms = float((live * live).sum())          # (j, k) pairs, diagonal in
    pairs = int(mask.sum())
    slots = N * A * K
    print(f"custom kernel inputs: N={N} A={A} K={K} live pairs={pairs} "
          f"(j, k) terms={terms:.0f} x M={M} float64", flush=True)
    gF = ((nk.nn_pair_gather(ck.pair_desc_vjp(g_desc, e_env, disp, mask,
                                               *args3), batch["rev"])
           - batch["f_target"])
          * batch["real"][..., None].to(torch.float64)).contiguous()
    in_bytes = slots * (3 * 8 + 1)              # disp, mask
    calls = {
        "pair_desc": ((disp, mask), lambda d, m: ck.pair_desc(d, m, *args3),
                      lambda d, m: ck.pair_desc_plain(d, m, *args3),
                      in_bytes + slots * (R + M + 1) * 8),
        "pair_desc_vjp": (
            (g_desc, e_env, disp, mask),
            lambda g, e, d, m: (ck.pair_desc_vjp(g, e, d, m, *args3),),
            lambda g, e, d, m: (ck.pair_desc_vjp_plain(g, e, d, m, *args3),),
            in_bytes + slots * (R + M + 1 + 3) * 8),
        "pair_desc_jvp": (
            (gF, disp, mask, jidx),
            lambda f, d, m, j: ck.pair_desc_jvp(f, d, m, *args3, jidx=j),
            lambda f, d, m, j: ck.pair_desc_jvp_plain(f, d, m, *args3,
                                                      jidx=j),
            in_bytes + gF.numel() * 8 + slots * 4
            + slots * (R + M + 1) * 8),
    }
    tag = "" if shape is None else f"@{tuple(shape)}"
    chunks = -(-M // (1 if M <= 2 else RECUR_MC))
    unordered = (terms - pairs) / 2             # s != o, each pair once
    for name, (args, kernel, plain, nbytes) in calls.items():
        out, ref = kernel(*args), plain(*args)
        radial = pairs * R * (EXP_OPS + 8)
        old = terms * M * GAUSS_OPS[name] + radial
        flops = unordered * (chunks * ANCHOR_OPS
                             + M * RECUR_PAIR_OPS[name]) \
            + pairs * M * DIAG_COL_OPS + radial
        record(rows, name + tag, list(out), list(ref),
               (rotating(kernel, args), 20), timed(rotating(plain, args), 5),
               nbytes, flops, None, wrapper=name,
               shape=[N, A, K], vector=True)
        rows[-1]["device_ms_l2"] = device_time(lambda: kernel(*args), 20)
        # the bound when every Gaussian costs its own exp
        rows[-1]["bound_ms_one_exp"] = bound_ms(nbytes, old)[0]
        if name == "pair_desc":
            print(f"pair_desc{tag} outputs' digest: {digest(out)}",
                  flush=True)
    if shape is not None:
        # the gather on the minibatch's lists, with seeded pair gradients
        # (zero on masked slots): the set's small cells are symmetric, so
        # their forces from K15V's gradients cancel to rounding
        g = torch.as_tensor(np.random.default_rng(0).normal(
            size=(N, A, K, 3)), device=disp.device) * mask[..., None]
        gather_row(rows, g.contiguous(), batch["rev"], jidx, mask, tag)
    return batch


def custom_kernel_checks(fs):
    """K15, K15V and K15T against their plain versions on a minibatch of 4
    at the pairwise mode's largest bucket and at its (8, 64) bucket, and
    the loss gradient through PairDescForce against plain double autograd
    through the plain descriptors on the largest."""
    import torch
    from fitsnap_tpu_torch.kernels import nn_kernels as nk
    from fitsnap_tpu_torch.ops import custom_desc as ops

    sol = fs.solver
    sec = sol._custom
    shape = (sec.cutoff, sec.num_radial, sec.num_3body)
    R, M = sec.num_radial, sec.num_3body
    rows = []
    batch = custom_kernel_rows(rows, sol)
    custom_kernel_rows(rows, sol, SMALL_BUCKET)
    N, A, K = batch["mask"].shape
    terms = float((batch["mask"].sum(-1).to(torch.float64) ** 2).sum())
    pairs = int(batch["mask"].sum())

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


# ---------------------------------------------------------------------------
# phase 23: the float32 cached and OTF NN fits
# ---------------------------------------------------------------------------


def bucket_bytes(sol):
    """{dtype: bytes} of the tensors an NN solver's buckets keep."""
    import torch

    out = {}
    for b in sol.buckets:
        for v in b.values():
            if torch.is_tensor(v):
                k = str(v.dtype).removeprefix("torch.")
                out[k] = out.get(k, 0) + v.numel() * v.element_size()
    return out


def f32_model_check(sol, sol64):
    """The float32 model's energies and forces on a minibatch of 4 of the
    largest bucket against the float64 path's on the same configs, its
    parameters and standardization widened to float64; returns the largest
    difference relative to the float64 outputs' largest magnitude."""
    import torch
    from fitsnap_tpu_torch.models.mlp import PerElementMLP

    bi = int(np.argmax([np.prod(b["shape"]) for b in sol64.buckets]))
    if [b["shape"] for b in sol.buckets] != [b["shape"] for b in
                                            sol64.buckets]:
        raise AssertionError("the float32 and float64 fits planned other "
                             "buckets")
    idx = np.arange(min(4, len(sol64.buckets[bi]["groups"])))
    e32, f32 = sol._forward()(sol.model, sol._gather(sol.buckets[bi], idx))
    saved = sol64.mean, sol64.std
    sol64.mean, sol64.std = sol.mean.double(), sol.std.double()
    try:
        e64, f64 = sol64._forward()(
            PerElementMLP([(w.double(), b.double())
                           for w, b in sol.model.params]),
            sol64._gather(sol64.buckets[bi], idx))
    finally:
        sol64.mean, sol64.std = saved
    if e32.dtype != torch.float32 or f32.dtype != torch.float32:
        raise AssertionError("the float32 model's outputs are not float32")
    return rel_err([e32.double(), f32.double()], [e64, f64])[1]


def f32_kernel_row(rows, name, calls, nbytes, flops, shape, tag, turns,
                   library=None):
    """A float32 kernel against its float32 plain version (1e-4), two calls
    bit for bit, timed by CUDA events (`record`); its float32 and float64
    calls on rotating copies of the same configs are added to `turns`,
    whose trace (`kernel_turns`) gives the row's device ms.  `calls` =
    (kernel32, plain32, kernel64, args32, args64): the kernels take the
    args and return a list of tensors."""
    import torch

    k32, p32, k64, a32, a64 = calls
    out, again = k32(*a32), k32(*a32)
    if not all(torch.equal(x, y) for x, y in zip(out, again)):
        raise AssertionError(f"{name}: two calls differ")
    if not all(x.dtype == torch.float32 for x in out):
        raise AssertionError(f"{name}: outputs not float32")
    DIGESTS[name + tag] = digest(out)
    # the rotating copies made (and their copy kernels finished) before any
    # trace
    r32, r64 = rotating(k32, a32), rotating(k64, a64)
    torch.cuda.synchronize()
    record(rows, name + tag, out, p32(*a32), (r32, 20),
           timed(rotating(p32, a32), 5), nbytes, flops, None,
           wrapper=name, shape=shape, fp32=True, rtol=KERNEL_RTOL_NN32,
           library=library, trace=False)
    turns.append((rows[-1], r32, r64))


# the profiler's names of the six float32 NN kernels' functions (each a
# template on the working type: "<float" or "<double" follows the name)
NN_F32_FN = {"nn_ut_b_f32": "nn_ut_b_kernel",
             "nn_dedu_vg_f32": "nn_dedu_vg_kernel",
             "nn_dedu_vg_t_f32": "nn_dedu_vg_t_kernel",
             "nn_pair_force_f32": "nn_pair_force_kernel",
             "nn_pair_force_t_f32": "nn_pair_force_t_kernel",
             "nn_pair_gather_f32": "nn_gather_kernel"}


def kernel_turns(turns, reps=20):
    """The float32 and float64 instances of each kernel of `turns` (row,
    float32 call, float64 call) in turns in one torch.profiler trace (each
    call `reps` times, float32 then float64, the whole sequence twice);
    each row gets the mean device ms a call of its kernel's function at
    each type, told apart by the template's type: `device_ms` the float32
    one, `f64_device_ms` the float64 one (a 20-call trace late in this
    script can miss kernels; this long one holds both types)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _, r32, r64 in turns:
        r32(), r64()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            for _, r32, r64 in turns:
                for fn in (r32, r64):
                    for _ in range(reps):
                        fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            times[e.key] = times.get(e.key, 0.0) \
                + e.self_device_time_total / 1e3
    for row, _, _ in turns:
        fn = NN_F32_FN[row["kernel"]]
        out = {}
        for key, ctype in (("f32", "float"), ("f64", "double")):
            ms = sum(v for k, v in times.items()
                     if re.search(rf"\b{fn}<{ctype}\b", k))
            out[key] = ms / (2 * reps) if times else None
        row["device_ms"], row["f64_device_ms"] = out["f32"], out["f64"]
        print(f"{row['name']}: device ms a call in turns float32 "
              f"{out['f32']} float64 {out['f64']}", flush=True)


def nn_f32_kernel_rows(sol, sol64):
    """K9, K10, K10T, K11, K11T and the gather at float32 against their
    float32 plain versions on minibatches of 4 at the cached mode's largest
    (4 x 128 x 64) and smallest (4 x 8 x 64) buckets of the float32 fit,
    beside their float64 instances on the float64 fit's same configs; the
    inputs of each from the plain versions' outputs, as in phase 13."""
    import torch
    from fitsnap_tpu_torch.kernels import nn_kernels as nk
    from fitsnap_tpu_torch.kernels import snap_kernels as sk
    from fitsnap_tpu_torch.ops.snap import nn_tables

    rows = []
    for pick in (np.argmax, np.argmin):
        ins, turns = {}, []
        tag = ""
        for key, s in (("f32", sol), ("f64", sol64)):
            batch, dEdB, block = nn_cached_batch(s, pick=pick)
            p = s._snap.cast(block[0].dtype)
            N, A, K = batch["jidx"].shape
            z = sk.zlist_plain(batch["ut"].reshape(N * A, -1), p)
            vg = nk.nn_dedu_vg_plain(dEdB, *z, p)
            g = nk.nn_pair_force_plain(vg, *block, p)
            F = nk.nn_pair_gather_plain(g.reshape(N, A, K, 3), batch["rev"])
            gF = ((F - batch["f_target"])
                  * batch["real"][..., None].to(F.dtype)).contiguous()
            vgc = nk.nn_pair_force_t_plain(gF, batch["jidx"], *block, p)
            ins[key] = dict(p=p, block=block, z=z, dEdB=dEdB, vg=vg,
                            g=g.reshape(N, A, K, 3), gF=gF, vgc=vgc,
                            jidx=batch["jidx"], rev=batch["rev"],
                            mask=batch["mask"])
        p = ins["f32"]["p"]
        tb = nn_tables(p)
        block, rev = ins["f32"]["block"], ins["f32"]["rev"]
        N, A, K = ins["f32"]["jidx"].shape
        M, n_t, W, U = N * A, tb.n_t, p.ntriples, p.u_len
        pairs = int(block[2].sum().item())
        pair_in = M * K * (3 * 4 + 4 + 1) + M * 4
        nzr = referenced_z(tb)
        shape = [N, A, K]
        if pick is np.argmin:
            tag = f"@{(A, K)}"
        print(f"nn float32 kernel inputs: N={N} A={A} K={K} W={W} 2U={2 * U}"
              f" n_t={n_t} live pairs={pairs}", flush=True)

        def calls(kernel, plain, args):
            """The float32 and float64 calls of a wrapper on the
            arguments named in `args`, each with its type's plan."""
            def a(key):
                d = ins[key]
                return tuple(x for n in args for x in (
                    d[n] if isinstance(d[n], tuple) else (d[n],)))

            def wrap(f, key):
                q = ins[key]["p"]

                def run(*xs):
                    out = f(*xs, q)
                    return list(out) if isinstance(out, tuple) else [out]
                return run
            return (wrap(kernel, "f32"), wrap(plain, "f32"),
                    wrap(kernel, "f64"), a("f32"), a("f64"))

        f32_kernel_row(
            rows, "nn_ut_b_f32",
            calls(nk.nn_ut_b, nk.nn_ut_b_plain, ("block",)),
            pair_in + M * (2 * U + W) * 4,
            pairs * (2 * n_t * n_t + 3 * n_t + 4 * (p.twojmax + 1)
                     + 4 * EXP_OPS + 20)
            + M * (2 * tb.lgc_val.numel() + 12 * len(tb.bt_c)),
            shape, tag, turns)
        f32_kernel_row(
            rows, "nn_dedu_vg_f32",
            calls(nk.nn_dedu_vg, nk.nn_dedu_vg_plain, ("dEdB", "z")),
            M * (W + 2 * nzr + n_t * n_t) * 4,
            M * (5 * len(tb.yu_fac) + 2 * tb.lgr_val.numel()),
            shape, tag, turns)
        f32_kernel_row(
            rows, "nn_pair_force_f32",
            calls(nk.nn_pair_force, nk.nn_pair_force_plain, ("vg", "block")),
            pair_in + M * n_t * n_t * 4 + M * K * 3 * 4,
            pairs * (8 * n_t * n_t + 600), shape, tag, turns)
        g32, g64 = ins["f32"]["g"], ins["f64"]["g"]
        mask = ins["f32"]["mask"]
        if pick is np.argmin:
            # seeded pair gradients on the live slots: the trained model's
            # forces on the bucket's symmetric cells cancel to rounding
            seeded = torch.as_tensor(np.random.default_rng(0).normal(
                size=tuple(g64.shape)), device=g64.device) \
                * mask[..., None].to(g64.dtype)
            g32, g64 = seeded.to(torch.float32), seeded
        dest = (torch.arange(N, device=g32.device)[:, None, None] * A
                + ins["f32"]["jidx"].long())[mask]
        scat = torch.zeros((N * A, 3), dtype=g32.dtype, device=g32.device)
        f32_kernel_row(
            rows, "nn_pair_gather_f32",
            (lambda g, r: [nk.nn_pair_gather(g, r)],
             lambda g, r: [nk.nn_pair_gather_plain(g, r)],
             lambda g, r: [nk.nn_pair_gather(g, r)],
             (g32, rev), (g64, ins["f64"]["rev"])),
            N * A * K * 3 * 4 + rev.numel() * 4 + N * A * 3 * 4,
            N * A * 3 * (K + rev.shape[2]), shape, tag, turns,
            library=rotating(lambda d, gr: scat.index_add_(0, d, gr),
                             (dest, g32[mask])))
        f32_kernel_row(
            rows, "nn_pair_force_t_f32",
            calls(nk.nn_pair_force_t, nk.nn_pair_force_t_plain,
                  ("gF", "jidx", "block")),
            M * 3 * 4 + M * K * 4 + pair_in + M * n_t * n_t * 4,
            pairs * (4 * n_t * n_t + 600), shape, tag, turns)
        f32_kernel_row(
            rows, "nn_dedu_vg_t_f32",
            calls(nk.nn_dedu_vg_t, nk.nn_dedu_vg_t_plain, ("vgc", "z")),
            M * (n_t * n_t + 2 * nzr + W) * 4,
            M * (2 * tb.lgc_val.numel() + 5 * len(tb.yu_fac)),
            shape, tag, turns)
        kernel_turns(turns)
    return rows


def epoch_turns(pairs):
    """One profiled epoch of each (tag, FitSnap) of `pairs` (float64, then
    float32) in turns: {tag: device ms of the epoch}.  Wall seconds an
    epoch are the fits' own (`nn seconds per epoch`)."""
    out = {}
    for tag, fs in pairs:
        net = fs.solver.net
        epochs, net.num_epochs = net.num_epochs, 1
        try:
            kernels = profile_kernels(fs.solver.perform_fit)
        finally:
            net.num_epochs = epochs
        out[tag] = sum(kernels.values()) if kernels else None
    print("nn epochs in turns (device ms): " + json.dumps(out), flush=True)
    return out


def nn_f32_phase(tmp, keep):
    """Phase 23: the cached and OTF fits of phases 13 and 14 at float32
    (`--dtype float32`), each against its float64 fit in `keep` ({mode:
    (FitSnap, checks)}); the six float32 kernels against their plain
    versions, timed beside their float64 instances in one trace; an epoch
    of each mode at each type in turns.  Returns (kernel rows, {path: (counts, times,
    checks)})."""
    import torch

    t_phase = time.time()
    paths, fits = {}, {}
    for mode in ("cached", "otf"):
        fs64, checks64 = keep[mode]
        fs, counts, times, checks = nn_path(tmp, "cuda", mode, "float32")
        sol, sol64 = fs.solver, fs64.solver
        floats = sorted({f"{k}: {v.dtype}" for b in sol.buckets
                         for k, v in b.items() if torch.is_tensor(v)
                         and v.is_floating_point()
                         and v.dtype != torch.float32})
        kept = [sol.mean, sol.std] + list(sol.model.parameters())
        if floats or any(t.dtype != torch.float32 for t in kept):
            raise AssertionError(f"the float32 {mode} fit keeps other floats: "
                                 f"{floats}")
        h32 = np.array(checks["history"])[:, 1]
        h64 = np.array(checks64["history"])[:, 1]
        gap = float(np.max(np.abs(h32 - h64) / np.abs(h64)))
        model_err = f32_model_check(sol, sol64)
        by_type = {"float32": bucket_bytes(sol),
                   "float64": bucket_bytes(sol64)}
        print(f"nn {mode} float32: buckets' bytes by type "
              f"{json.dumps(by_type)}; train loss vs the float64 fit's, "
              f"largest relative gap {gap:.3e} (limit {LOSS_RTOL32}); the "
              f"model vs the float64 path at its parameters widened "
              f"{model_err:.3e} (limit {MODEL_RTOL32})", flush=True)
        if not (gap <= LOSS_RTOL32 and model_err <= MODEL_RTOL32):
            raise AssertionError(f"the float32 {mode} fit is off its float64 "
                                 f"fit: loss {gap:.3e}, model {model_err:.3e}")
        checks.update(loss_gap_f64=gap, model_rel_err_f64=model_err,
                      bucket_bytes=by_type)
        paths[NN_F32_PATH[mode]] = (counts, times, checks)
        fits[mode] = fs
    rows = nn_f32_kernel_rows(fits["cached"].solver, keep["cached"][0].solver)
    for mode in ("cached", "otf"):
        paths[NN_F32_PATH[mode]][2]["epoch_turns"] = epoch_turns(
            [(f"{mode} float64", keep[mode][0]),
             (f"{mode} float32", fits[mode])])
    print(f"phase 23 (float32 NN fits): {time.time() - t_phase:.1f} s",
          flush=True)
    return rows, paths


# ---------------------------------------------------------------------------
# host copies: XYZ and VASP scrapers, host solvers, --torchprof, FD harness
# ---------------------------------------------------------------------------


def g17(x):
    """Floats as %.17g, space-separated: they read back exactly."""
    return " ".join(f"{v:.17g}" for v in np.ravel(x))


def json_set(root):
    """{group: [config dict]} of a FitSNAP JSON set, each group's configs
    in the JSON scraper's (sorted file name) order."""
    return {folder.name: [
        json.loads(f.read_text())["Dataset"]["Data"][0]
        for f in sorted(folder.iterdir()) if f.suffix == ".json"]
        for folder in sorted(Path(root).iterdir()) if folder.is_dir()}


def write_xyz_set(configs, root):
    """One extended-XYZ file a group (`<group>.extxyz`), its frames in the
    JSON scraper's order."""
    root.mkdir(parents=True, exist_ok=True)
    for group, confs in configs.items():
        lines = []
        for c in confs:
            lines += [str(c["NumAtoms"]),
                      f'Lattice="{g17(c["Lattice"])}" '
                      "Properties=species:S:1:pos:R:3:forces:R:3 "
                      f'energy={c["Energy"]:.17g} stress="{g17(c["Stress"])}"'
                      ' pbc="T T T"']
            lines += [f"{t} {g17(p)} {g17(f)}" for t, p, f in zip(
                c["AtomTypes"], c["Positions"], c["Forces"])]
        (root / f"{group}.extxyz").write_text("\n".join(lines) + "\n")


def write_vasp_set(configs, root):
    """Each group as two OUTCAR trees (`<group>/run_a/OUTCAR` holds the
    first half of its configs as ionic steps, `<group>/run_b/relax/OUTCAR`
    the rest) in the layout the VASP scraper reads, stress in kB."""
    for group, confs in configs.items():
        half = (len(confs) + 1) // 2
        for rel, part in (("run_a/OUTCAR", confs[:half]),
                          ("run_b/relax/OUTCAR", confs[half:])):
            if not part:
                continue
            out = [f"   VRHFIN ={part[0]['AtomTypes'][0]}: synthetic",
                   f"   ions per type =  {part[0]['NumAtoms']}"]
            for c in part:
                s = np.asarray(c["Stress"]) / 1000.0
                out += ["  aborting loop because EDIFF is reached",
                        " direct lattice vectors        reciprocal lattice "
                        "vectors"]
                out += [f"  {g17(v)}  0 0 0" for v in c["Lattice"]]
                out.append("  in kB  " + g17([s[0, 0], s[1, 1], s[2, 2],
                                               s[0, 1], s[1, 2], s[2, 0]]))
                out += [" POSITION          TOTAL-FORCE (eV/Angst)",
                        " " + "-" * 80]
                out += [f"  {g17(p)}  {g17(f)}"
                        for p, f in zip(c["Positions"], c["Forces"])]
                e = f"{c['Energy']:.17g}"
                out += [" " + "-" * 80,
                        "  FREE ENERGIE OF THE ION-ELECTRON SYSTEM (eV)",
                        "  " + "-" * 50,
                        f"  free  energy   TOTEN  =  {e} eV", "",
                        f"  energy  without entropy=  {e}  "
                        f"energy(sigma->0) =  {e}"]
            path = root / group / rel
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text("\n".join(out) + "\n")


def config_rows(fs):
    """{(group, energy): the row indices of its config} of a FitSnap's A,
    from its data order (an energy row, 3N force rows, 6 stress rows a
    config), held to its Row_Type list."""
    out, types, r = {}, [], 0
    for d in fs.data:
        n = d["NumAtoms"]
        key = (d["Group"], float(d["Energy"]))
        if key in out:
            raise AssertionError(f"two configs share the key {key}")
        out[key] = np.arange(r, r + 1 + 3 * n + 6)
        types += ["Energy"] + ["Force"] * (3 * n) + ["Stress"] * 6
        r += 1 + 3 * n + 6
    if types != list(fs.fs_dict["Row_Type"]):
        raise AssertionError("rows are not one energy, 3N force and 6 "
                             "stress rows a config, in data order")
    return out


def col_err(x, ref):
    """Largest difference over each column's largest |ref|."""
    x, ref = np.asarray(x, float), np.asarray(ref, float)
    if x.shape != ref.shape:
        raise AssertionError(f"shape {x.shape} != {ref.shape}")
    x, ref = x.reshape(len(x), -1), ref.reshape(len(ref), -1)
    scale = np.maximum(np.abs(ref).max(0), 1e-300)
    return float((np.abs(x - ref).max(0) / scale).max())


def fitsnap_run(settings, ini, device):
    """FitSnap on `settings` (written to `ini`): scrape, process, fit,
    output, the launch counts set to 0 just before and read just after;
    returns (the FitSnap, counts, wall seconds)."""
    import torch
    from fitsnap_tpu_torch import FitSnap
    from fitsnap_tpu_torch.tools import synthetic

    synthetic.write_ini(ini, settings)
    reset_launches()
    t0 = time.time()
    fs = FitSnap(str(ini), arglist=["--overwrite"], device=device)
    fs.scrape_configs()
    fs.process_configs()
    fs.perform_fit()
    fs.write_output()
    torch.cuda.synchronize()
    return fs, launches(), time.time() - t0


def xyz_settings(root, groups=None):
    """The Ta_Linear_JCP2014 sections on the XYZ set (`groups`: all)."""
    from fitsnap_tpu_torch.tools import synthetic

    s = synthetic.ta_settings(root, groups)
    s["SCRAPER"] = {"scraper": "XYZ"}
    return s


def xyz_check(tmp, ref, device):
    """Phase 19 (a): the XYZ set through FitSnap against phase 4's fit."""
    fs, counts, wall = fitsnap_run(xyz_settings(Path(tmp) / "XYZ"),
                                   Path(tmp) / "xyz.in", device)
    check_launched(counts, "xyz_fitsnap")
    got = {k: counts[k] for k in FITSNAP_KERNELS}
    want = {k: ref["counts"][k] for k in FITSNAP_KERNELS}
    if got != want:
        raise AssertionError(f"K1-K5 launched {got} on the XYZ path, {want} "
                             f"on phase 4's")
    rows = config_rows(fs)
    if set(rows) != set(ref["rows"]):
        raise AssertionError("the XYZ and JSON sets hold other configs")
    # this run's rows in phase 4's config order
    order = np.concatenate([rows[k] for k in ref["rows"]])
    errs = {name: col_err(getattr(fs, name)[order], ref[name])
            for name in ("a", "b", "w")}
    if not np.array_equal(np.asarray(fs.fs_dict["Testing"])[order],
                          ref["testing"]):
        raise AssertionError("the XYZ and JSON scrapers split the groups "
                             "into other training and testing configs")
    tol = 100 * ref["cond"] * EPS64
    beta_err = float(np.abs(fs.fit - ref["fit"]).max()
                     / np.abs(ref["fit"]).max())
    print(f"xyz path: A / b / w against phase 4's {errs}, fit {beta_err:.3e}"
          f" (limit {tol:.3e}); scrape {fs.timings['scrape']:.3f} s (JSON, "
          f"phase 4: {ref['scrape']:.3f} s)", flush=True)
    if not (max(errs.values()) <= A_RTOL and beta_err <= tol):
        raise AssertionError(f"the XYZ fit differs from phase 4's: {errs}, "
                             f"fit {beta_err:.3e} (limit {tol:.3e})")
    checks = {"rows_rel_err": errs, "fit_rel_err": beta_err,
              "fit_tol": tol, "order_is_phase4s": bool(
                  np.array_equal(order, np.arange(len(order))))}
    return fs, counts, dict(fs.timings, wall=wall), checks


def vasp_check(tmp, configs, device):
    """Phase 19 (b): the set as OUTCAR trees through FitSnap, then again
    from the vJSON cache."""
    from fitsnap_tpu_torch.tools import synthetic

    root = Path(tmp) / "VASP"
    write_vasp_set(configs, root)
    s = synthetic.ta_settings(root)
    s["SCRAPER"] = {"scraper": "VASP"}
    s["GROUPS"]["vasp_json_pathname"] = str(Path(tmp) / "vJSON")
    fs, counts, wall = fitsnap_run(s, Path(tmp) / "vasp.in", device)
    check_launched(counts, "vasp_fitsnap")
    a_plain = fs.calculator.process_configs(fs.data, plain=True)[0]
    a_err = col_err(fs.a, a_plain)
    cached = len(list((Path(tmp) / "vJSON").rglob("*.json")))
    fs2, _, wall2 = fitsnap_run(s, Path(tmp) / "vasp.in", device)
    again = col_err(fs2.a, fs.a)
    times = {"scrape": fs.timings["scrape"],
             "scrape_cached": fs2.timings["scrape"]}
    print(f"vasp path: A against the plain path's {a_err:.3e}, from the "
          f"cache {again:.3e} ({cached} vJSON files); scrape "
          f"{times['scrape']:.3f} s, from the cache "
          f"{times['scrape_cached']:.3f} s", flush=True)
    if not (a_err <= A_RTOL and again <= A_RTOL
            and cached == len(fs.data) == sum(map(len, configs.values()))):
        raise AssertionError(f"the VASP path: A {a_err:.3e}, cached A "
                             f"{again:.3e}, {cached} cache files for "
                             f"{len(fs.data)} configs")
    checks = {"a_rel_err": a_err, "cached_a_rel_err": again,
              "rows": int(fs.a.shape[0]), "configs": len(fs.data)}
    return counts, dict(fs.timings, wall=wall, wall_cached=wall2,
                        scrape_cached=fs2.timings["scrape"]), checks


def host_lstsq(a, fs):
    """numpy's lstsq of a FitSnap's weighted training rows with `a`."""
    train = ~np.asarray(fs.fs_dict["Testing"])
    return np.linalg.lstsq(fs.w[train][:, None] * a[train],
                           fs.w[train] * fs.b[train], rcond=SVD_RCOND)[0]


def solver_checks(tmp, ref, a_plain, device):
    """Phase 19 (c): FitSnap on the XYZ set with each host solver that
    needs no sklearn, against the same solver on the host with A_plain."""
    out = {}
    for name, extra in HOST_SOLVERS.items():
        s = xyz_settings(Path(tmp) / "XYZ",
                         [] if name in SUBSET_GROUPS else None)
        s["GROUPS"].update(SUBSET_GROUPS.get(name, {}))
        s["SOLVER"] = {"solver": name}
        s["OUTFILE"] = {"metrics": f"Ta_{name}_metrics.json",
                        "potential": f"Ta_{name}_pot",
                        "metrics_style": "JSON"}
        for section, kv in extra.items():
            s.setdefault(section, {}).update(kv)
        fs, _, wall = fitsnap_run(s, Path(tmp) / f"xyz_{name}.in", device)
        metrics = json.loads(Path(f"Ta_{name}_metrics.json").read_text())
        if set(metrics) != {"ncount", "mae", "rmse", "rsq"} or not all(
                np.isfinite(v) for c in ("ncount", "mae", "rmse")
                for v in metrics[c].values()):
            raise AssertionError(f"{name}: the JSON metrics read back "
                                 f"wrong: {sorted(metrics)}")
        rows = config_rows(fs)
        a_host = a_plain[np.concatenate([ref["rows"][k] for k in rows])]
        host = type(fs.solver)(name, fs.config)
        t0 = time.time()
        host.perform_fit(a_host, fs.b, fs.w, fs.fs_dict)
        host_s = time.time() - t0
        train = ~np.asarray(fs.fs_dict["Testing"])
        sv = np.linalg.svd(fs.w[train][:, None] * a_host[train],
                           compute_uv=False)
        # each of these solvers forms the weighted normal matrix AᵀA (RIDGE,
        # ANL, BCS and MERR factor it, OPT steps on its gradient), so a
        # difference in A reaches the fit through cond(AᵀA) = cond(A)²
        cond = float(sv[0] / sv[-1]) ** 2
        apart = float(np.abs(fs.fit - host.fit).max()
                      / np.abs(host.fit).max())
        if name == "MCMC":
            err = float(np.abs(fs.solver.fit_sam.mean(0)
                               - host.fit_sam.mean(0)).max())
            tol = MCMC_MEAN_TOL
        elif name in PATH_DEPENDENT:
            err = col_err(fs.a, a_host)
            tol = A_RTOL
            print(f"solver {name}: its rows against A_plain's {err:.3e}; "
                  f"its fit against {name} on A_plain {apart:.3e} "
                  f"(context)", flush=True)
        else:
            err, tol = apart, 100 * cond * EPS64
        if name == "OPT":
            from fitsnap_tpu_torch.solvers.linear import _solver_rng
            x0 = _solver_rng(fs.config).standard_normal(fs.a.shape[1])
            print(f"solver OPT: moved {np.abs(fs.fit - x0).max():.3e} from "
                  f"its seeded start; lstsq's fit is "
                  f"{np.abs(fs.fit - host_lstsq(a_host, fs)).max():.3e} "
                  f"from it (context)", flush=True)
        out[name] = {"fit_s": fs.timings["fit"], "host_fit_s": host_s,
                     "wall_s": wall, "rows": int(fs.a.shape[0]),
                     "cond_ata": cond, "err": err, "tol": tol,
                     "fit_rel_diff_a_plain": apart,
                     "metrics_groups": len(metrics["mae"])}
        print(f"solver {name}: {fs.timings['fit']:.3f} s on the card path "
              f"(the host solver on A_plain {host_s:.3f} s), "
              f"{fs.a.shape[0]} rows, checked {err:.3e} (limit {tol:.3e}, "
              f"cond(AᵀA) {cond:.3e})", flush=True)
        if not (np.isfinite(fs.fit).all() and err <= tol):
            raise AssertionError(f"{name}: the card path's fit differs from "
                                 f"the host's: {err:.3e} > {tol:.3e}")
    return out


def torchprof_check(tmp, root, device):
    """Phase 19 (d): the CLI with --torchprof on the card; its trace must
    name K1-K5's kernels."""
    from fitsnap_tpu_torch.tools import synthetic

    run = Path(tmp) / "torchprof_run"
    run.mkdir()
    # one group of the XYZ set: the trace needs K1-K5, not the whole set
    ini = run / "xyz_prof.in"
    s = xyz_settings(Path(tmp) / "XYZ", [])
    s["GROUPS"].update(SUBSET_GROUPS["BCS"])
    synthetic.write_ini(ini, s)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "fitsnap_tpu_torch", str(ini),
         "--overwrite", "--device", device, "--torchprof",
         str(run / "trace")],
        cwd=run, env=env, capture_output=True, text=True, timeout=600)
    seconds = time.time() - t0
    if proc.returncode != 0:
        raise AssertionError(f"--torchprof run failed:\n{proc.stderr[-3000:]}")
    traces = list((run / "trace").glob("*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"--torchprof wrote {traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "kernel"}
    found = {k: sum(k in n for n in names) > 0 for k in TRACE_KERNELS}
    stages = " ".join(" ".join(line.split()) for line in
                      proc.stdout.splitlines()[-4:])
    print(f"--torchprof: {seconds:.1f} s (its stages: {stages}), trace "
          f"{traces[0].stat().st_size} B, {len(names)} kernel names, K1-K5 "
          f"named: {found}", flush=True)
    if not all(found.values()):
        raise AssertionError(f"the --torchprof trace lacks {found}")
    return {"torchprof_s": seconds, "trace_bytes": traces[0].stat().st_size,
            "trace_kernel_names": len(names)}


def fd_harness_check(tmp, device):
    """Phase 19 (e): tools/test_tools.TestTools on phase 12's precompute
    NN settings on the card."""
    from fitsnap_tpu_torch.tools import synthetic
    from fitsnap_tpu_torch.tools.test_tools import TestTools

    t0 = time.time()
    tt = TestTools(synthetic.nn_settings(Path(tmp) / "JSON"), device=device)
    mean, worst, details = tt.finite_difference(
        "Displaced_BCC", config_index=0, max_atoms=2)
    seconds = time.time() - t0
    print(f"FD harness (TestTools, h=1e-5): mean error {mean:.3e}, max "
          f"{worst:.3e} (bar {FD_BAR}) over {len(details)} coordinates, "
          f"{seconds:.1f} s", flush=True)
    if not (tt.fs.solver.device.type == device and worst < FD_BAR):
        raise AssertionError(f"FD harness: max error {worst:.3e}")
    return {"fd_harness_mean_err": mean, "fd_harness_max_err": worst,
            "fd_harness_s": seconds}


def host_copies_phase(tmp, ref, a_plain, root, device="cuda"):
    """Phase 19: the XYZ and VASP paths, the host solvers, --torchprof and
    the FD harness on the Ta set of phase 2; returns the paths' (counts,
    timings, checks)."""
    t0 = time.time()
    configs = json_set(Path(tmp) / "JSON")
    write_xyz_set(configs, Path(tmp) / "XYZ")
    fs, counts, times, checks = xyz_check(tmp, ref, device)
    del fs
    paths = {"vasp_fitsnap": vasp_check(tmp, configs, device)}
    checks["solvers"] = solver_checks(tmp, ref, a_plain, device)
    checks.update(torchprof_check(tmp, root, device),
                  **fd_harness_check(tmp, device))
    paths["xyz_fitsnap"] = (counts, times, checks)
    print(f"host copies phase: {time.time() - t0:.1f} s", flush=True)
    return paths


# ---------------------------------------------------------------------------
# phase 20: the native neighbor builder and multi-GPU over torch.distributed
# ---------------------------------------------------------------------------


def native_check(ini, device):
    """Phase 20 (a): the native builder's lists against the numpy version's
    on every config of the Ta set (mask and jidx equal, disp within
    DISP_ATOL), and FitSnap's process seconds with each, in turns."""
    from fitsnap_tpu_torch import FitSnap
    from fitsnap_tpu_torch.calculators import snap as csnap
    from fitsnap_tpu_torch.ops import neighbors

    fs = FitSnap(str(ini), arglist=["--overwrite"], device=device)
    fs.scrape_configs()
    calc = fs.calculator
    worst, slots = 0.0, 0
    t0 = time.time()
    for d in fs.data:
        pc = calc._pack(d)
        got = neighbors.host_neighbors(pc.pos, pc.cell, pc.natoms,
                                       calc.cutoff)
        want = neighbors.host_neighbors_plain(pc.pos, pc.cell, pc.natoms,
                                              calc.cutoff)
        if not (np.array_equal(got[1], want[1])
                and np.array_equal(got[2], want[2]) and got[3] == want[3]):
            raise AssertionError(f"native lists differ from the plain "
                                 f"ones on {d['File']}")
        worst = max(worst, float(np.abs(got[0] - want[0]).max(initial=0.0)))
        slots += int(got[2].sum())
    t_lists = time.time() - t0
    if not worst <= DISP_ATOL:
        raise AssertionError(f"native disp differs by {worst:.3e}")
    seconds = {"native": [], "plain": []}
    for name in ("plain", "native", "native", "plain"):
        with contextlib.ExitStack() as stack:
            if name == "plain":
                stack.callback(setattr, csnap, "host_neighbors",
                               csnap.host_neighbors)
                csnap.host_neighbors = neighbors.host_neighbors_plain
            fs.process_configs()
        seconds[name].append(fs.timings["process"])
    print(f"native lists: {len(fs.data)} configs, {slots} pair slots equal "
          f"to the plain lists (disp within {worst:.3e}); both builders "
          f"{t_lists:.2f} s; process s native {seconds['native']} plain "
          f"{seconds['plain']}", flush=True)
    return {"native_configs": len(fs.data), "native_disp_max_err": worst,
            "process_s_native": seconds["native"],
            "process_s_plain": seconds["plain"]}


def dp_streamed(ini, device):
    """The streamed pass of phase 5 (plan_shift_groups, chunk_size, the
    accumulating step with device lists) over the whole set on `device`,
    each rank of a group taking its half of every chunk; returns (AtA, Atb,
    nrows, chunks)."""
    from fitsnap_tpu_torch import FitSnap
    from fitsnap_tpu_torch.calculators.snap import chunk_size
    from fitsnap_tpu_torch.parallel import fit

    fs = FitSnap(str(ini), arglist=["--overwrite"], device=device)
    fs.scrape_configs()
    calc = fs.calculator
    packed = [calc._pack(d) for d in fs.data]
    acc, finish, chunks = None, None, 0
    for g in fit.plan_shift_groups(packed, calc.cutoff):
        per = chunk_size(g["a_pad"], g["k_pad"], calc.desc_width())
        if per % DP_RANKS:
            raise AssertionError(f"a chunk of {per} configs does not split "
                                 f"over {DP_RANKS} ranks")
        n = -(-len(g["configs"]) // per)
        batch = fit.put_batch(fit.pack_batch_pos(
            g["configs"], g["a_pad"], n * per, g["s_table"], np.float64,
            chunks=n), device)
        acc_step, init, finish = fit.build_step_fn(
            calc.params, calc.numtypes, FLAGS, device,
            refspec=calc.refspec, accumulate=True,
            neighbors={"cutoff": calc.cutoff, "k_pad": g["k_pad"]})
        acc = acc_step(acc or init(), batch)
        chunks += n
    return (*finish(acc), chunks)


def dp_nn(tmp, device, tag):
    """The cached NN fit of phase 13 for DP_EPOCHS epochs in its own
    directory; returns (loss curve, parameters as numpy)."""
    from fitsnap_tpu_torch import FitSnap
    from fitsnap_tpu_torch.models.mlp import params_to_numpy
    from fitsnap_tpu_torch.tools import synthetic

    s = synthetic.nn_settings(Path(tmp) / "JSON", dgrad_mode="cached")
    s["PYTORCH"]["num_epochs"] = DP_EPOCHS
    run = Path(tmp) / "dp" / tag
    run.mkdir(parents=True, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(run)
    try:
        fs = FitSnap(s, arglist=["--overwrite"], device=device)
        fs.scrape_configs()
        fs.process_configs()
        fs.perform_fit()
        fs.write_output()
    finally:
        os.chdir(cwd)
    return np.array(fs.solver.history), params_to_numpy(
        fs.solver.model.params)


def dp_spatial(ini, arrays, device):
    """build_spatial_rows_fn of the SNAP model on one config's arrays."""
    from fitsnap_tpu_torch import FitSnap
    from fitsnap_tpu_torch.parallel import fit

    calc = FitSnap(str(ini), arglist=["--overwrite"], device=device) \
        .calculator
    return fit.build_spatial_rows_fn(calc.params, calc.numtypes, FLAGS,
                                     device)(*arrays)


def spatial_arrays(ini):
    """One config of the Ta set, its largest, as build_spatial_rows_fn's
    arguments: host lists (the native builder) over an even number of atom
    slots, its truths and weights."""
    from fitsnap_tpu_torch import FitSnap
    from fitsnap_tpu_torch.ops.neighbors import host_neighbors

    fs = FitSnap(str(ini), arglist=["--overwrite"], device="cpu")
    fs.scrape_configs()
    calc = fs.calculator
    pc = max((calc._pack(d) for d in fs.data), key=lambda pc: pc.natoms)
    a_pad = pc.natoms + pc.natoms % DP_RANKS
    disp, jidx, mask, _ = host_neighbors(pc.pos, pc.cell, pc.natoms,
                                         calc.cutoff, a_pad=a_pad)
    d = pc.data
    st = np.asarray(d["Stress"])
    forces = np.zeros((a_pad, 3))
    forces[:pc.natoms] = d["Forces"]
    types = np.zeros(a_pad, np.int32)
    types[:pc.natoms] = pc.types
    return (disp, jidx, mask, types, pc.natoms, pc.cell, d["Energy"],
            forces, st[[0, 1, 2, 1, 0, 0], [0, 1, 2, 2, 2, 1]],
            d["eweight"], d["fweight"], d["vweight"])


def halo_check(rows, arrays, width, device):
    """K4's gather_only mode (the spatial rows' halo) against its plain
    version at the spatial config's shapes: rank 0's block of a DP_RANKS
    split, seeded per-pair gradients of `width` columns, the gathers into
    the next block, with index_add_ of those slots as library call; adds
    its row to `rows` and returns its relative error."""
    import torch
    from fitsnap_tpu_torch.kernels import snap_kernels as sk

    disp, jidx, mask = (torch.as_tensor(np.asarray(x), device=device)
                        for x in arrays[:3])
    Ash = disp.shape[0] // DP_RANKS
    disp, jidx, mask = disp[None, :Ash], jidx[None, :Ash], mask[None, :Ash]
    local = jidx - Ash
    into = mask & (local >= 0) & (local < Ash)
    rev, _ = sk.reverse_table_plain(torch.where(into, local, 0)
                                    .to(torch.int32), into)
    K = mask.shape[2]
    gen = torch.Generator(device="cpu").manual_seed(20)
    G = (torch.randn((1, Ash, width, K, 3), generator=gen,
                     dtype=torch.float64).to(device)
         * mask[:, :, None, :, None]).contiguous()
    types = torch.zeros((1, Ash), dtype=torch.int32, device=device)
    args = (G, disp, mask, rev, types, 1)
    out, _ = sk.pair_scatter_rows(*args, gather_only=True)
    ref, _ = sk.pair_scatter_rows_plain(*args, gather_only=True)
    nslots = int(into.sum().item())
    dest = local[into].long()
    g_rows = G.permute(0, 1, 3, 2, 4)[into].reshape(-1, width * 3)
    scat = torch.zeros((Ash, width * 3), dtype=G.dtype, device=device)
    nbytes = nslots * width * 3 * 8 + rev.numel() * 4 + Ash * 4 \
        + out.numel() * 8
    record(rows, "pair_scatter_rows@halo", [out], [ref],
           (lambda: sk.pair_scatter_rows(*args, gather_only=True), 20),
           timed(lambda: sk.pair_scatter_rows_plain(*args,
                                                    gather_only=True), 5),
           nbytes, nslots * width * 3, None, wrapper="pair_scatter_rows",
           shape=f"spatial halo, gather_only: 1 x {Ash} x {K}, width "
                 f"{width}, {nslots} slots into the next block",
           library=lambda: scat.index_add_(0, dest, g_rows))
    return rows[-1]["max_rel_err"]


def dp_worker(rank, store, tmp, ini, system, arrays, device, results):
    """Phase 20 (c): one of DP_RANKS gloo ranks, all on `device` (spawned;
    cuda:0 on the card)."""
    import torch
    import torch.distributed as dist

    def sync():
        if device.startswith("cuda"):
            torch.cuda.synchronize()

    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=DP_RANKS)
        from fitsnap_tpu_torch.solvers.tpu_svd import TpuSVD

        reset_launches()
        out = {"streamed": dp_streamed(ini, device)}
        sync()
        out["streamed_counts"] = launches()
        out["svd"] = TpuSVD("TPUSVD", None, device).perform_fit(*system)
        out["nn"] = dp_nn(tmp, device, f"gloo{rank}")
        out["spatial"] = dp_spatial(ini, arrays, device)
        sync()
        out["counts"] = launches()
        dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        import traceback
        results.put((rank, False, traceback.format_exc()))


def gloo_ranks(tmp, ini, system, arrays, device):
    """Start DP_RANKS spawned processes on `device` and collect their
    results; raises on a failed rank, and stops every process."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store = Path(tempfile.mkdtemp(dir=tmp)) / "gloo_store"
    procs = [ctx.Process(target=dp_worker, args=(
        r, str(store), tmp, ini, system, arrays, device, results))
        for r in range(DP_RANKS)]
    for p in procs:
        p.start()
    try:
        out = {}
        for _ in procs:
            rank, ok, value = results.get(timeout=DP_TIMEOUT)
            if not ok:
                raise AssertionError(f"gloo rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(60)
        return [out[r] for r in range(DP_RANKS)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)


def normal_cond(a, w, testing):
    """cond of the equilibrated normal matrix NormalSolver solves for the
    training rows (over the eigenvalues it keeps)."""
    aw = w[~testing, None] * a[~testing]
    ata = aw.T @ aw
    d = np.sqrt(np.clip(np.diag(ata), 1e-300, None))
    ev = np.linalg.eigvalsh(ata / d[:, None] / d[None, :])
    kept = ev[ev > 10 * EPS64 * ev[-1]]
    return float(kept[-1] / kept[0])


def rel_dist(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-300))


def missing_kernels(counts, path):
    return [k for k in PATH_KERNELS[path] if counts[k] == 0]


def distributed_phase(tmp, ini, ref, keep, kernels, device="cuda"):
    """Phase 20: (a) the native builder, and K4's halo mode (its row added
    to `kernels`), (b) NCCL with one rank bit for bit against the same
    code without a group, (c) DP_RANKS gloo ranks on cuda:0 against (b);
    returns the paths' (counts, timings, checks).
    With device "cpu" (a rehearsal without the card) (b) takes gloo."""
    import torch
    import torch.distributed as dist
    from fitsnap_tpu_torch.solvers.tpu_svd import TpuSVD

    t_phase = time.time()
    checks = native_check(ini, device)
    system = (ref["a"], ref["b"], ref["w"],
              {"Testing": list(ref["testing"])})
    arrays = spatial_arrays(ini)
    checks["halo_gather_rel_err"] = halo_check(kernels, arrays,
                                               ref["a"].shape[1], device)
    print(f"K4 gather_only (the spatial halo) against its plain version: "
          f"{checks['halo_gather_rel_err']:.3e}", flush=True)
    # the same code without a group
    svd0 = TpuSVD("TPUSVD", None, device).perform_fit(*system)
    nn0 = dp_nn(tmp, device, "none")
    spatial0 = dp_spatial(ini, arrays, device)
    # (b) NCCL, one rank
    t0 = time.time()
    store = Path(tempfile.mkdtemp(dir=tmp)) / "nccl_store"
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        if device == "cuda":
            torch.cuda.set_device(0)
        reset_launches()
        AtA, Atb, nrows = keep["one_pass"]()
        torch.cuda.synchronize()
        stream_counts = launches()
        svd1 = TpuSVD("TPUSVD", None, device).perform_fit(*system)
        nn1 = dp_nn(tmp, device, "nccl")
        torch.cuda.synchronize()
        nccl_counts = launches()
    finally:
        dist.destroy_process_group()
    t_nccl = time.time() - t0
    AtA0, Atb0, nrows0 = keep["result"]
    same = {"streamed_ata": np.array_equal(AtA, AtA0),
            "streamed_atb": np.array_equal(Atb, Atb0),
            "streamed_nrows": nrows == nrows0,
            "tpu_svd": np.array_equal(svd1, svd0),
            "nn_history": np.array_equal(nn1[0], nn0[0]),
            "nn_params": all(np.array_equal(x, y)
                             for lx, ly in zip(nn1[1], nn0[1])
                             for x, y in zip(lx, ly))}
    print(f"nccl, one rank: bitwise equal to no group: {json.dumps(same)}; "
          f"{t_nccl:.1f} s", flush=True)
    if not all(same.values()):
        raise AssertionError(f"NCCL world 1 differs from no group: {same}")
    # (c) DP_RANKS gloo ranks sharing cuda:0
    t0 = time.time()
    ranks = gloo_ranks(tmp, ini, system, arrays,
                       "cuda:0" if device == "cuda" else device)
    t_gloo = time.time() - t0
    gloo_counts = {k: sum(r["counts"][k] for r in ranks)
                   for k in ranks[0]["counts"]}
    err = {}
    for r, out in enumerate(ranks):
        a, b, n, chunks = out["streamed"]
        err[f"streamed_ata_{r}"] = rel_dist(a, AtA)
        err[f"streamed_atb_{r}"] = rel_dist(b, Atb)
        err[f"tpu_svd_{r}"] = rel_dist(out["svd"], svd1)
        curve = out["nn"][0][:, 1:]
        err[f"nn_loss_{r}"] = float((np.abs(curve - nn1[0][:, 1:])
                                     / np.abs(nn1[0][:, 1:])).max())
        err[f"spatial_ata_{r}"] = rel_dist(out["spatial"][0], spatial0[0])
        err[f"spatial_atb_{r}"] = rel_dist(out["spatial"][1], spatial0[1])
        if n != nrows or out["spatial"][2] != spatial0[2]:
            raise AssertionError(f"gloo rank {r}: nrows {n} / "
                                 f"{out['spatial'][2]}, not {nrows} / "
                                 f"{spatial0[2]}")
        # each rank launches once a chunk, on its half of the chunk
        unequal = {k: (out["streamed_counts"][k], stream_counts[k])
                   for k in PATH_KERNELS["streamed"]
                   if out["streamed_counts"][k] != stream_counts[k]}
        if unequal:
            raise AssertionError(f"gloo rank {r}'s streamed launches differ "
                                 f"from the NCCL run's: {unequal}")
    # a split of the rows reorders AtA's sums, which moves the solve by up
    # to cond eps: TpuSVD is held to the larger of DP_SVD_RTOL and 100 cond
    # eps, as phase 19 holds the host solvers
    cond = normal_cond(ref["a"], ref["w"], ref["testing"])
    svd_limit = max(DP_SVD_RTOL, 100 * cond * EPS64)
    limits = {"streamed": DP_NORMAL_RTOL, "spatial": DP_NORMAL_RTOL,
              "tpu_svd": svd_limit, "nn_loss": DP_LOSS_RTOL}
    over = {k: v for k, v in err.items()
            if not v <= next(lim for kind, lim in limits.items()
                             if k.startswith(kind))}
    print(f"gloo, {DP_RANKS} ranks on cuda:0: errors against NCCL world 1 "
          f"(spatial: against no group) {json.dumps(err)}; TpuSVD limit "
          f"{svd_limit:.3e} (cond {cond:.3e}); streamed "
          f"launches a rank {json.dumps(ranks[0]['streamed_counts'])}; "
          f"{t_gloo:.1f} s", flush=True)
    if over:
        raise AssertionError(f"gloo ranks beyond their limits: {over}")
    for path, counts in (("dp_nccl1", nccl_counts),
                         ("dp_gloo2", gloo_counts)):
        missing = missing_kernels(counts, path)
        if missing:
            raise AssertionError(f"kernels never launched on the {path} "
                                 f"path: {missing}")
    checks.update({f"{k}_rel_err": v for k, v in err.items()},
                  nccl_bitwise=same, streamed_chunks=ranks[0]["streamed"][3],
                  tpu_svd_cond=cond, tpu_svd_limit=svd_limit)
    times = {"nccl_s": t_nccl, "gloo_s": t_gloo,
             "phase_s": time.time() - t_phase}
    print(f"distributed phase: {times['phase_s']:.1f} s", flush=True)
    return {"dp_nccl1": (nccl_counts, times, checks),
            "dp_gloo2": (gloo_counts, times, {})}


# ---------------------------------------------------------------------------
# phase 21: twojmax 13-16
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def shared_plans(cache):
    """The SNAP calculators' make_params memoized by the section values a
    plan depends on (`PLAN_KEYS`) while the block runs, so that every path
    of a twojmax shares one plan; each build's seconds go to
    cache["seconds"][(twojmax, channels)]."""
    from fitsnap_tpu_torch.calculators import snap as csnap
    from fitsnap_tpu_torch.ops import snap as osnap

    build = csnap.make_params
    plan_build = osnap.build_snap_plan

    def keep_dense(*args, **kw):
        # the one-channel plans' dense term tables, K2's library call's
        plan = plan_build(*args, **kw)
        if not kw.get("chemflag"):
            cache["z_dense", kw.get("twojmax", args[0] if args else None)] \
                = plan.z_dense["groups"]
        return plan

    def shared(sec, device):
        key = (tuple(repr(getattr(sec, k, None)) for k in PLAN_KEYS),
               str(device))
        if key not in cache:
            t0 = time.time()
            cache[key] = build(sec, device)
            seconds = cache.setdefault("seconds", {})
            plan = (cache[key].twojmax, cache[key].nchem)
            seconds[plan] = seconds.get(plan, 0.0) + time.time() - t0
        return cache[key]

    csnap.make_params = shared
    osnap.build_snap_plan = keep_dense
    try:
        yield
    finally:
        csnap.make_params = build
        osnap.build_snap_plan = plan_build


def peak_gb():
    """The card's peak allocated memory since the last reset, GB."""
    import torch

    return torch.cuda.max_memory_allocated() / 1e9


def grid_rows(rows, p, k1_in, jidx, tag):
    """K9, K10, K11, K11T and K10T against their plain versions on a
    chunk's SNAP lists (k1_in flat over its C x A atoms, jidx (C, A, K))
    with a seeded dE/dB and force cotangent, as phase 13's rows: K9 on the
    lists, K10 on the seeded dE/dB and K2's z-lists of K9's ut, K11 on the
    plain K10's grid cotangent, K11T on the seeded force cotangent, K10T on
    the plain K11T's grid cotangent."""
    import torch
    from fitsnap_tpu_torch.kernels import nn_kernels as nk
    from fitsnap_tpu_torch.kernels import snap_kernels as sk
    from fitsnap_tpu_torch.ops.snap import nn_tables

    tb = nn_tables(p)
    n_t, W = tb.n_t, p.ntriples
    C, A, K = jidx.shape
    M = C * A
    shape = [C, A, K]
    rng = np.random.default_rng(21)
    ut, _ = k9_row(rows, k1_in, p, tag, shape)
    z = sk.zlist(ut, p)
    dEdB = torch.as_tensor(rng.normal(size=(M, W)), device=ut.device)
    vg = k10_row(rows, dEdB, z, p, tag, shape)
    pairs = int(k1_in[2].sum().item())
    pair_in = M * K * (3 * 8 + 4 + 1) + M * 4
    args = (vg,) + tuple(k1_in)
    record(rows, f"nn_pair_force{tag}", [nk.nn_pair_force(*args, p)],
           [nk.nn_pair_force_plain(*args, p)],
           (lambda: nk.nn_pair_force(*args, p), 10),
           timed(lambda: nk.nn_pair_force_plain(*args, p), 3),
           pair_in + M * n_t * n_t * 8 + M * K * 3 * 8,
           pairs * (8 * n_t * n_t + 600), None, wrapper="nn_pair_force",
           shape=shape, vector=True)
    gF = torch.as_tensor(rng.normal(size=(C, A, 3)), device=ut.device)
    args = (gF, jidx) + tuple(k1_in)
    out = nk.nn_pair_force_t(*args, p)
    if not torch.equal(out, nk.nn_pair_force_t(*args, p)):
        raise AssertionError(f"nn_pair_force_t{tag}: two calls differ")
    vgc = nk.nn_pair_force_t_plain(*args, p)
    record(rows, f"nn_pair_force_t{tag}", [out], [vgc],
           (lambda: nk.nn_pair_force_t(*args, p), 10),
           timed(lambda: nk.nn_pair_force_t_plain(*args, p), 3),
           M * 3 * 8 + M * K * 4 + pair_in + M * n_t * n_t * 8,
           pairs * (4 * n_t * n_t + 600), None, wrapper="nn_pair_force_t",
           shape=shape, vector=True)
    args = (vgc,) + tuple(z)
    record(rows, f"nn_dedu_vg_t{tag}", [nk.nn_dedu_vg_t(*args, p)],
           [nk.nn_dedu_vg_t_plain(*args, p)],
           (lambda: nk.nn_dedu_vg_t(*args, p), 10),
           timed(lambda: nk.nn_dedu_vg_t_plain(*args, p), 3),
           M * (n_t * n_t + 2 * referenced_z(tb) + W) * 8,
           M * (2 * tb.lgc_val.numel() + 5 * len(tb.yu_fac)), None,
           wrapper="nn_dedu_vg_t", shape=shape, vector=True)


def turns(order, run):
    """`run(tag)` for each tag of `order` and then in reverse (the
    measurement in turns: a, b, b, a); {tag: [results in order]}."""
    out = {}
    for tag in list(order) + list(order)[::-1]:
        out.setdefault(tag, []).append(run(tag))
    return out


def k1_shapes(rows, fs, k1_in):
    """K1 at each twojmax of `SHAPE_TJ` (the Ta section's other values) on
    a chunk's K1 inputs in each of its shapes (`K1_SHAPES`, each forced),
    each against the plain version, then timed in turns (window,
    recursion, ..., recursion, window); returns {twojmax: (the planner's
    shape and splits, {shape: ms in turns})}."""
    import torch
    from fitsnap_tpu_torch.calculators import snap as csnap
    from fitsnap_tpu_torch.kernels import snap_kernels as sk

    N, K = k1_in[2].shape
    sms = torch.cuda.get_device_properties(
        k1_in[0].device).multi_processor_count
    kept = sk.K1_SHAPES, sk.K1_WINDOW_SPLITS
    out = {}
    for tj in SHAPE_TJ:
        sec = SimpleNamespace(**{k: getattr(fs.calculator.sec, k, None)
                                 for k in PLAN_KEYS})
        sec.twojmax = [tj]
        p = csnap.make_params(sec, fs.device)
        plan = sk.pair_u_plan(p, N, K, sms)

        def run(tag):
            # the shape forced (the window at any split count)
            sk.K1_SHAPES, sk.K1_WINDOW_SPLITS = (tag,), 1 << 30
            if not any(r["name"] == f"pair_u_duals@tj{tj}_{tag}"
                       for r in rows):
                k1_row(rows, p, k1_in, f"tj{tj}_{tag}")
            return timed(lambda: sk.pair_u_duals(*k1_in, p), 10)

        try:
            ms = turns(kept[0], run)
        finally:
            sk.K1_SHAPES, sk.K1_WINDOW_SPLITS = kept
        print(f"K1 at twojmax {tj} on {N} atoms x {K} slots: planner "
              f"{plan}; ms in turns: " + json.dumps(
                  {k: [round(x, 4) for x in v] for k, v in ms.items()}),
              flush=True)
        out[tj] = (list(plan), ms)
    return out


def k3_shape_turns(rows, p, k1_in, tag):
    """K3 at a chunk past twojmax 12 in its slab shape (forced; the
    planner takes the level shape with one channel) against the plain
    version as a row `dbdd@<tag>_slab`, then both shapes timed in turns
    (level, slab, slab, level; CUDA events); returns {shape: [ms]}."""
    from fitsnap_tpu_torch.kernels import snap_kernels as sk

    J, ut = sk.pair_u_duals_plain(*k1_in, p)
    z = sk.zlist_plain(ut, p)
    kept = sk.K3_SHAPES
    N, K = k1_in[2].shape
    U, W = p.u_len, p.nb_base
    shape0 = sk.dbdd_shape(p, K)

    def run(shape):
        sk.K3_SHAPES = (shape,)
        if shape != shape0 and not any(
                r["name"] == f"dbdd@{tag}_{shape}" for r in rows):
            record(rows, f"dbdd@{tag}_{shape}", sk.dbdd(ut, *z, J, p),
                   sk.dbdd_plain(ut, *z, J, p),
                   (lambda: sk.dbdd(ut, *z, J, p), 10),
                   timed(lambda: sk.dbdd_plain(ut, *z, J, p), 3),
                   (N * 2 * U + 2 * N * p.nz + 3 * N * K * 2 * U + N * W
                    + N * W * K * 3) * 8, k3_operations(p, k1_in), None,
                   wrapper=f"dbdd_{shape}", shape=f"{tag}_{shape}")
        return timed(lambda: sk.dbdd(ut, *z, J, p), 10)

    try:
        out = turns([shape0] + [s for s in kept if s != shape0], run)
    finally:
        sk.K3_SHAPES = kept
    print(f"{tag}: K3 ms in turns (the planner's shape first): "
          + json.dumps({s: [round(x, 4) for x in v] for s, v in out.items()}),
          flush=True)
    return out


def pass_shape_turns(one_pass, tag):
    """The device ms of a steady streamed pass with K3 in its planner's
    shape ("new": the level shape) and in the slab shape it took before
    ("old"), in turns (new, old, old, new)."""
    from fitsnap_tpu_torch.kernels import snap_kernels as sk

    kept = sk.K3_SHAPES

    def run(tag):
        sk.K3_SHAPES = ("slab",) if tag == "old" else kept
        try:
            kernel_ms = profile_kernels(one_pass)
        finally:
            sk.K3_SHAPES = kept
        return (round(sum(kernel_ms.values()), 4) if kernel_ms else None,
                {k: round(v, 4) for k, v in kernel_ms.items()})

    out = turns(("new", "old"), run)
    print(f"{card_line()}: streamed pass at {tag}, device ms in turns (K3 "
          f"level, slab, slab, level): level "
          f"{[x[0] for x in out['new']]} slab {[x[0] for x in out['old']]}; "
          f"split (level, then slab): {json.dumps(out['new'][0][1])} "
          f"{json.dumps(out['old'][0][1])}", flush=True)
    return {k: [x[0] for x in v] for k, v in out.items()}


def large_nn_path(tmp, root, tj, mode, device):
    """The NN fit at `tj` on phase 21's set (its `LARGE_NN_GROUPS`) in
    `mode` ("auto", which must
    resolve to the cached mode, or "otf") for LARGE_EPOCHS epochs: launch
    counts set to 0 just before and read just after; it fails unless K5,
    K8, K8r, K2, K9-K11T and the gather launched, K1, K3, K4 and K12's
    contraction did not, no bucket holds dB/dD (OTF: nor disp or ut), the
    losses are finite and the same fit with every kernel's plain version
    on the card has the same loss curve (1e-10).  Returns (the FitSnap,
    counts, timings, checks)."""
    import torch
    from fitsnap_tpu_torch import FitSnap
    from fitsnap_tpu_torch.tools import synthetic

    tag = f"tj{tj}_{mode}"
    settings = synthetic.nn_settings(root, list(LARGE_NN_GROUPS),
                                     dgrad_mode=mode)
    settings["BISPECTRUM"]["twojmax"] = tj
    settings["PYTORCH"]["num_epochs"] = LARGE_EPOCHS
    synthetic.write_ini(Path(tmp) / f"nn_{tag}.in", settings)
    path = f"tj{tj}_nn_{'otf' if mode == 'otf' else 'cached'}_fitsnap"
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    fs = FitSnap(str(Path(tmp) / f"nn_{tag}.in"), arglist=["--overwrite"],
                 device=device)
    fs.scrape_configs()
    fs.process_configs()
    fs.perform_fit()
    fs.write_output()
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launches()
    sol = fs.solver
    check_launched(counts, path)
    stray = {k: counts[k] for k in NN_CACHED_ABSENT if counts[k]}
    if stray:
        raise AssertionError(f"the {path} path launched {stray}")
    stored = [k for b in sol.buckets for k in ("G", "disp", "ut") if k in b]
    if (mode == "otf" and (stored or not sol.otf)) or (
            mode != "otf" and (not sol.cached or "G" in stored)):
        raise AssertionError(f"the {path} path (cached={sol.cached}, "
                             f"otf={sol.otf}) stored {stored}")
    hist = np.array(sol.history)
    print(f"nn loss curve ({tag}; epoch, train, validation): "
          + json.dumps(hist.tolist()), flush=True)
    if not np.isfinite(hist).all():
        raise AssertionError(f"nn {tag}: the losses are not finite")
    checks = {"configs": len(fs.data), "width": int(sol._snap.nb_base),
              "buckets": {str(b["shape"]): len(b["groups"])
                          for b in sol.buckets},
              "train_loss_first": hist[0, 1], "train_loss_last": hist[-1, 1],
              "peak_gb": peak_gb()}
    checks.update(plain_fit_check(fs, tmp, tag))
    times = dict(fs.timings, wall=wall, epoch_first=sol.epoch_times[0],
                 epoch_mean_rest=float(np.mean(sol.epoch_times[1:])))
    return fs, path, (counts, times, checks)


def large_twojmax_phase(tmp, seed, device="cuda"):
    """Phase 21: every SNAP path past twojmax 12 (`LARGE_TJ`: the kernels
    at the first, FitSnap at the last two, the streamed fit at the second,
    the NN fits at the last) and the chemflag modes at 12.  Returns
    (kernel rows, {path: (counts, timings, checks)})."""
    import torch
    from fitsnap_tpu_torch import FitSnap
    from fitsnap_tpu_torch.tools import synthetic

    t_phase = time.time()
    tj_kern, tj_fit, tj_nn = LARGE_TJ
    rows, paths, cache, sets, shape_ms = [], {}, {}, {}, {}
    with shared_plans(cache):
        # the kernels-only twojmax reads the next one's set
        for tj in (tj_fit, tj_kern, tj_nn):
            t0 = time.time()
            if tj == tj_kern:
                # kernels alone, on the configs of the next set
                settings = synthetic.ta_settings(
                    Path(tmp) / f"TJ{tj_fit}_JSON", list(LARGE_COUNTS))
                settings["BISPECTRUM"]["twojmax"] = tj
                synthetic.write_ini(Path(tmp) / f"tj{tj}.in", settings)
                fs0 = FitSnap(str(Path(tmp) / f"tj{tj}.in"),
                              arglist=["--overwrite"], device=device)
                data = fs0.scrape_configs()
            else:
                ini, fs0, data, a_plain, beta, _ = make_dataset(
                    tmp, seed, device, twojmax=tj)
                sets[tj] = (ini, a_plain, beta)
            calc = fs0.calculator
            p = calc.params
            _, args, k1_in, smask = snap_chunk(
                calc, data, "Displaced_BCC", LARGE_CHUNK[tj])
            C, A, K = smask.shape
            print(f"twojmax {tj}: plan {cache['seconds'][tj, 1]:.2f} s, "
                  f"U {p.u_len}, width {p.nb_base}; set-up "
                  f"{time.time() - t0:.2f} s; kernel inputs C={C} A={A} "
                  f"K={K} pairs={int(smask.sum().item())}", flush=True)
            torch.cuda.reset_peak_memory_stats()
            descriptor_checks(rows, p, k1_in, f"tj{tj}",
                              k2_library=cache.pop(("z_dense", tj)))
            shape_ms[tj] = k3_shape_turns(rows, p, k1_in, f"tj{tj}")
            if tj != tj_kern:
                grid_rows(rows, p, k1_in, args[1], f"@tj{tj}")
            if tj == tj_fit:
                k1_shape_ms = k1_shapes(rows, fs0, k1_in)
            print(f"twojmax {tj} kernels: peak {peak_gb():.2f} GB",
                  flush=True)
            del fs0, data, args, k1_in, smask
            torch.cuda.empty_cache()
        # the chemflag modes of K1-K3 at WINDOW_TJ on phase 9's InP set
        settings = synthetic.inp_settings(Path(tmp) / "INP_JSON")
        settings["BISPECTRUM"]["twojmax"] = f"{WINDOW_TJ} {WINDOW_TJ}"
        synthetic.write_ini(Path(tmp) / "inp_large.in", settings)
        t0 = time.time()
        fs0 = FitSnap(str(Path(tmp) / "inp_large.in"),
                      arglist=["--overwrite"], device=device)
        data = fs0.scrape_configs()
        _, _, k1_in, smask = snap_chunk(fs0.calculator, data,
                                        "Displaced_ZB64")
        C, A, K = smask.shape
        print(f"InP chemflag twojmax {WINDOW_TJ}: plan "
              f"{cache['seconds'][WINDOW_TJ, 2]:.2f} s, "
              f"set-up {time.time() - t0:.2f} s, width "
              f"{fs0.calculator.params.nb_base}; kernel inputs C={C} A={A} "
              f"K={K}", flush=True)
        descriptor_checks(rows, fs0.calculator.params, k1_in,
                          f"InP_tj{WINDOW_TJ}", k2_library=False)
        del fs0, data, k1_in, smask
        torch.cuda.empty_cache()

        # FitSnap at the last two, the streamed fit at the first of them
        for tj in (tj_fit, tj_nn):
            ini, a_plain, beta = sets[tj]
            torch.cuda.reset_peak_memory_stats()
            fs, *fitsnap = main_path(ini, a_plain, beta, device, f"tj{tj}")
            fitsnap[2]["peak_gb"] = peak_gb()
            fitsnap[2]["large_shapes"] = shape_ms
            if tj == tj_fit:
                fitsnap[2]["k1_shapes"] = k1_shape_ms
            paths[FITSNAP_PATH[f"tj{tj}"]] = fitsnap
            if tj == tj_fit:
                torch.cuda.reset_peak_memory_stats()
                keep = {}
                streamed = streamed_path(fs, a_plain, beta, seed, device,
                                         f"tj{tj}", keep=keep)
                streamed[2]["peak_gb"] = peak_gb()
                streamed[2]["pass_shapes"] = pass_shape_turns(
                    keep["one_pass"], f"tj{tj}")
                paths[STREAM_PATH[f"tj{tj}"]] = streamed
            del fs, a_plain
            torch.cuda.empty_cache()

        # the NN fits, cached (auto's pick), then OTF
        for mode in ("auto", "otf"):
            fs, path, result = large_nn_path(
                tmp, Path(tmp) / f"TJ{tj_nn}_JSON", tj_nn, mode, device)
            paths[path] = result
            del fs
            torch.cuda.empty_cache()
    seconds = cache.get("seconds", {})
    print(f"phase 21 (twojmax {', '.join(map(str, LARGE_TJ))}): "
          f"{time.time() - t_phase:.2f} s, of which planning "
          f"{sum(seconds.values()):.2f} s (" + ", ".join(
              f"twojmax {tj}, {nc} channel(s): {v:.2f} s"
              for (tj, nc), v in sorted(seconds.items())) + ")", flush=True)
    return rows, paths


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
            snap_keep = {}
            for kind in ("snap", "ace"):
                t0 = time.time()
                ini, fs0, data, a_plain, beta, t_plain = make_dataset(
                    tmp, args.seed, "cuda", kind)
                print(f"data ({kind}): {len(data)} configs, A "
                      f"{a_plain.shape}, plain path on the card "
                      f"{t_plain:.2f} s, set-up {time.time() - t0:.2f} s",
                      flush=True)
                kernels += (kernel_checks(fs0.calculator, data, args.seed)
                            if kind == "snap" else
                            ace_kernel_checks(fs0.calculator, data, args.seed))
                if kind == "snap":
                    # phase 22's kernels, on phase 3's chunk at float32
                    kernels += f32_kernel_checks(fs0.calculator, data)
                del fs0, data
                torch.cuda.empty_cache()
                fs, *fitsnap = main_path(ini, a_plain, beta, "cuda", kind)
                if kind == "snap":
                    # phase 4's rows and fit, for phase 19
                    snap_ref = {
                        "a": fs.a, "b": fs.b, "w": fs.w, "fit": fs.fit,
                        "testing": np.asarray(fs.fs_dict["Testing"]),
                        "rows": config_rows(fs), "counts": fitsnap[0],
                        "cond": fitsnap[2]["cond_weighted_a"],
                        "scrape": fs.timings["scrape"]}
                    snap_a_plain, snap_ini = a_plain, ini
                streamed = streamed_path(fs, a_plain, beta, args.seed,
                                         "cuda", kind,
                                         keep=snap_keep if kind == "snap"
                                         else None)
                paths[FITSNAP_PATH[kind]] = fitsnap
                paths[STREAM_PATH[kind]] = streamed
                if kind == "snap":
                    # phase 22: the same streamed fit at float32
                    paths["streamed_f32"] = streamed_f32_phase(
                        fs, a_plain, beta, args.seed, "cuda", snap_keep,
                        streamed[2])
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
            # SNAP with the zbl + coul/cut + spin reference on the Fe-shaped
            # set (its JSON carries Spins and Charges): FitSnap only, as the
            # streamed fit passes the reference no charges
            t0 = time.time()
            ini, fs0, data, a_plain, beta, t_plain = make_dataset(
                tmp, args.seed, "cuda", "fe")
            print(f"data (fe): {len(data)} configs, A {a_plain.shape}, "
                  f"plain path on the card {t_plain:.2f} s, set-up "
                  f"{time.time() - t0:.2f} s", flush=True)
            del fs0, data
            fs, *fitsnap = main_path(ini, a_plain, beta, "cuda", "fe")
            spec = fs.calculator.refspec
            packed = fs.calculator.host_preprocess(fs.data)[0]
            if not (spec.zbl and spec.coul and spec.spin and all(
                    pc.spins is not None and pc.charges is not None
                    for pc in packed)):
                raise AssertionError("the Fe fit's reference or its spins "
                                     "and charges are missing")
            paths[FITSNAP_PATH["fe"]] = fitsnap
            del fs, a_plain, packed
            torch.cuda.empty_cache()
            # phase 21, twojmax 13-16: the kernels, FitSnap, the streamed
            # fit and the NN fits (cached and OTF) past twojmax 12; before
            # the NN phases, after whose epoch profiles the profiler's
            # traces of this process hold no device time
            rows, more = large_twojmax_phase(tmp, args.seed)
            kernels += rows
            paths.update(more)
            # the NN fit on the Ta set of phase 2
            fs, counts, times, checks = nn_path(tmp, "cuda")
            rows, grad = nn_kernel_checks(fs)
            kernels += rows
            checks.update(grad, **fd_check(fs, nn_model_eval, "nn"),
                          **nn_export_check(fs))
            checks.update(nn_epoch_profile(fs, times["epoch_mean_rest"]))
            paths["nn_fitsnap"] = (counts, times, checks)
            del fs
            torch.cuda.empty_cache()
            # the NN fit in the cached mode on the same set (kept for
            # phase 23)
            fs, counts, times, checks = nn_path(tmp, "cuda", "cached")
            rows, grad = nn_cached_kernel_checks(fs)
            kernels += rows
            checks.update(grad, **nn_cross_mode_check(fs),
                          **fd_check(fs, nn_cached_eval, "nn cached"))
            checks.update(nn_epoch_profile(fs, times["epoch_mean_rest"]))
            paths["nn_cached_fitsnap"] = (counts, times, checks)
            nn_keep = {"cached": (fs, checks)}
            # the NN fit in the OTF mode: linear SNAP (kept for phase 23)
            # and quadraticflag on the same set, chemflag on the
            # InP-shaped set of phase 9
            for mode in ("otf", "otf_quadratic", "otf_chem"):
                fs, counts, times, checks = nn_path(tmp, "cuda", mode)
                groups = (("Displaced_ZB64", "Antisite_ZB64")
                          if mode == "otf_chem"
                          else ("Displaced_BCC", "Liquid"))
                checks.update(nn_otf_cross_check(fs), **fd_check(
                    fs, nn_otf_eval, f"nn {mode}", groups))
                checks.update(nn_epoch_profile(fs, times["epoch_mean_rest"]))
                paths[NN_PATH[mode]] = (counts, times, checks)
                if mode == "otf":
                    # phase 23: the float32 cached and OTF fits
                    nn_keep["otf"] = (fs, checks)
                    rows, more = nn_f32_phase(tmp, nn_keep)
                    kernels += rows
                    paths.update(more)
                    del nn_keep
                del fs
                torch.cuda.empty_cache()
            # nonlinear ACE (Ta_PACE) on the ACE set: precompute, then OTF
            for mode in ("ace", "ace_otf"):
                fs, counts, times, checks = nn_path(tmp, "cuda", mode)
                checks.update(ace_nn_checks(fs, tmp, mode,
                                            times["epoch_mean_rest"]))
                paths[NN_PATH[mode]] = (counts, times, checks)
                del fs
                torch.cuda.empty_cache()
            # the custom pairwise NN on the same set
            fs, counts, times, checks = nn_path(tmp, "cuda", "custom")
            rows, grad = custom_kernel_checks(fs)
            kernels += rows
            checks.update(grad, **fd_check(fs, custom_eval, "custom"),
                          **custom_export_check(fs))
            checks.update(nn_epoch_profile(fs, times["epoch_mean_rest"]))
            paths["custom_fitsnap"] = (counts, times, checks)
            del fs
            torch.cuda.empty_cache()
            # PAS: chemflag SNAP on the InP-shaped set (K9's element-channel
            # mode), then linear SNAP on the Ta set and ACE (Ta_PACE)
            pas_data(tmp, args.seed)
            for mode in ("pas_chem", "pas", "pas_ace"):
                fs, counts, times, checks = nn_path(tmp, "cuda", mode)
                rows, more = pas_checks(fs, tmp, mode,
                                        times["epoch_mean_rest"])
                kernels += rows
                checks.update(more)
                paths[NN_PATH[mode]] = (counts, times, checks)
                del fs
                torch.cuda.empty_cache()
            # the host copies: XYZ and VASP scrapers, host solvers,
            # --torchprof and the FD harness on the Ta set of phase 2
            paths.update(host_copies_phase(tmp, snap_ref, snap_a_plain,
                                           root))
            # the native neighbor builder and multi-GPU on the same set
            paths.update(distributed_phase(tmp, snap_ini, snap_ref,
                                           snap_keep, kernels))
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
        by_path = {path: counts.get(row["kernel"], 0)
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
