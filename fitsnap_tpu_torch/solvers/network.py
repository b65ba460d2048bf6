"""Neural-network solver (PyTorch), replacing the reference's PYTORCH /
NETWORK / JAX solvers, in the cached, OTF and precompute modes and as the
custom pairwise NN.

Counterpart of `fitsnap_tpu/solvers/network.py`.  `dgrad_mode = cached`
(what `auto` picks for linear SNAP, as in the JAX package): positions go to
the device in the buckets of `parallel/fit.plan_pos_buckets`, and one pass
builds the neighbor lists (K8), their reverse table (K8r), the per-atom ut
and B (K9, `calculators/snap.nn_analytic`) and the reference potential
(K5); the buckets keep those, no dB/dD.  Each step takes dE/dB back to the
pairs analytically (`NnCachedForce`: K2 z-lists of the cached ut, K10, K11
and the force gather; backward K11T and K10T).  `dgrad_mode = otf` (also
what `cached` falls back to under chemflag or quadraticflag, and what
`auto` picks when neither the cached mode's cache nor dB/dD fits): the
buckets keep the positions alone, the same pass forms the targets and the
standardization, and every step rebuilds the lists (K8, K8r) and the
descriptors from the positions.  Linear SNAP and quadraticflag then take
K9's ut and B into the cached step (under quadraticflag the MLP sees the
quadratic columns, and their dE/dB folds back onto the base columns ahead
of K10); chemflag takes B and dB/dD of the minibatch from K1-K3's chemflag
modes into the precompute step.  `dgrad_mode = precompute` (chemflag and
quadraticflag, or asked for): per-atom descriptors B and their per-pair
gradients G = dB/dD are computed on the device once
(`calculators/snap.nn_prep`: kernels K1-K5, K6q and the chemflag modes under
their flags), in shape buckets of configs padded to one (atoms, neighbor
slots) shape, and the forces go through K12 (`NnForce`, backward K12T).
Nonlinear ACE (calculator LAMMPSPACE) takes the same steps with K13 and K14
for B and dB/dD (`calculators/ace.nn_prep`); it has no pair-grid kit, so
its OTF mode takes chemflag's route (B and dB/dD of each minibatch from K13
and K14 into the precompute step) and `cached` falls back to OTF.
The custom pairwise NN (a [CUSTOM] section, calculator LAMMPSCUSTOM) takes
precedence over `dgrad_mode`, as in the JAX package: its buckets keep the
host neighbor lists (disp, jidx, mask, rev) on the device, and each step
computes the 31 Bessel / Gaussian 3-body pair descriptors with K15, runs
the MLP per pair (atom i's element), and takes the forces through
`PairDescForce` (K15V and the gather; backward K15T).  It fits the raw
energies and forces (no reference potential is subtracted).
Per-atom-scalar fitting (PAS, `per_atom_scalar` in [CALCULATOR], the
reference's FitTorchPAS) also takes precedence over `dgrad_mode`: its
buckets keep the per-atom descriptors B alone (SNAP: `nn_desc`, K9 in every
element channel under chemflag, with the quadratic columns; ACE: K13 and
K14's B) and the per-atom targets of the configs' `Chis`, and the network
maps each atom's standardized B to one scalar, with no energy contraction,
no forces and no reference potential.
Training is a per-epoch loop of minibatch steps: per-element MLP energies
(`models/mlp.py`), dE/dB by autograd with `create_graph`, the forces (whose
backward carries the force residual into the MLP's double backward), the
weighted MSE loss, and Adam as optax's `scale_by_adam` with the learning
rate applied outside it.

The minibatch plan, the validation split, the `e_mean` bias shift, the
warm start, best-validation tracking and the plateau scheduler are the JAX
package's, so both packages follow the same loss trajectory from the same
initial parameters.  The JAX package's epoch blocks and chunked programs
only arrange TPU dispatch (they compute the same trajectory), and are not
copied.

Data parallelism (JAX `--devices`, its "dp" mesh axis): under a process
group of W ranks every rank holds the whole prepared set, the plan is the
JAX package's data-parallel plan (a minibatch a multiple of W, the caps at
least W, sets smaller than a minibatch wrapped), and rank r takes the
contiguous r-th W-th of each minibatch's indices.  The loss's numerators
stay local and its normalizers are the whole minibatch's, counted on the
host from the index plan, so the summed local gradients and losses are
the single-device gradient and loss of the whole minibatch: a training
step sums them in one all_reduce, and the validation losses are summed
once an epoch.  Adam, the best epoch and the scheduler then run alike on
every rank.  Rank 0 alone writes files.
"""

import os
import time

import numpy as np
import torch

from fitsnap_tpu_torch.convert import mlp_params_from_numpy
from fitsnap_tpu_torch.io.screen import info, screen, warn
from fitsnap_tpu_torch.kernels import launch as kl
from fitsnap_tpu_torch.kernels.custom_kernels import (PairDescForce,
                                                      pair_desc,
                                                      pair_desc_vjp)
from fitsnap_tpu_torch.kernels.nn_kernels import (F32_TWOJMAX, NnCachedForce,
                                                  NnForce, nn_force,
                                                  nn_pair_gather)
from fitsnap_tpu_torch.models.mlp import (PerElementMLP, init_mlp,
                                          load_params, params_to_numpy,
                                          save_params)
from fitsnap_tpu_torch.ops.snap import _quad_extend, quad_fold
from fitsnap_tpu_torch.solvers.solver import (NN_COLUMNS, NN_INDEX_NAMES,
                                              PAS_COLUMNS, ErrorTable, Solver)
from fitsnap_tpu_torch.utils.torchsetup import (DTYPE, all_sum,
                                                from_rank_zero, open_output,
                                                resolve_device, share,
                                                working_type, world)

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
_BATCH_KEYS = ("B", "G", "types", "real", "nat", "jidx", "rev", "e_target",
               "f_target", "ew", "fw")
# the cached mode's buckets: "types" holds the atoms' element (the
# descriptor side's), "elem" the network index (zeroed unless
# multi_element_option is 2)
_BATCH_KEYS_CACHED = ("disp", "jidx", "mask", "rev", "ut", "B", "types",
                      "elem", "real", "nat", "e_target", "f_target", "ew",
                      "fw")
# the OTF mode's buckets: positions (hi/lo parts, float64) and image shift
# vectors; k_pad is the bucket's "shape"[1]
_BATCH_KEYS_OTF = ("pos_hi", "pos_lo", "svec_hi", "svec_lo", "types", "elem",
                   "real", "nat", "e_target", "f_target", "ew", "fw")
# the pairwise mode's buckets: host neighbor lists, no descriptors
_BATCH_KEYS_PW = ("disp", "jidx", "mask", "rev", "types", "real", "nat",
                  "e_target", "f_target", "ew", "fw")
# the PAS buckets: descriptors and per-atom targets, no forces
_BATCH_KEYS_PAS = ("B", "types", "real", "nat", "pas_target", "ew")
# The plan's defaults, each read from its variable of the JAX package where
# that package reads it (`plan_var`).  dgrad_mode = auto: the cached mode
# while its neighbor and per-atom cache stays within NEIGH_LIMIT bytes
# (FITSNAP_TPU_NN_NEIGH_LIMIT), else the stored dB/dD within G_LIMIT
# (FITSNAP_TPU_NN_G_LIMIT), else the OTF mode
NEIGH_LIMIT = 4 << 30
G_LIMIT = 2 << 30
MAX_PROGRAMS = 10           # plan_pos_buckets' cap (_NN_MAX_PROGRAMS)
CACHED_PAIRS = 390_000      # the cached mode's pair slots a step (_NN_PAIRS)
ATOMS_PER_BATCH = 0         # atoms a minibatch grows to, 0: off (_NN_ATOMS_..)
APB_PAIRS = 390_000         # pair slots a step under ATOMS_PER_BATCH
OTF_CANDIDATES = 1 << 25    # the OTF mode's (A, S, A) candidates per minibatch
PAIR_CHUNK = 1 << 20        # pair slots per K15 call of the pairwise stats


def plan_var(name, default, parse=int):
    """Plan variable FITSNAP_TPU_<name> of the environment, parsed as the
    JAX package parses it, else `default`."""
    return parse(os.environ.get("FITSNAP_TPU_" + name, str(default)))


def refuse_float32(config, mode=None, dtype=torch.float32):
    """At float32 the NN solver takes the cached and OTF modes of linear
    SNAP networks up to twojmax F32_TWOJMAX alone: raise, naming the
    ROADMAP.md queue item that ports it, for anything else, from the
    configuration alone (`mode`, by default the section's dgrad_mode:
    "auto" passes until it is resolved)."""
    if dtype != torch.float32:
        return
    mode = _net_section(config).dgrad_mode if mode is None else mode
    sections = config.sections
    bs = sections.get("BISPECTRUM")
    if "CUSTOM" in sections or sections["CALCULATOR"].per_atom_scalar:
        what, queue = ("the pairwise NN" if "CUSTOM" in sections else "PAS",
                       kl.QUEUE_NN)
    elif sections["CALCULATOR"].calculator.upper() != "LAMMPSSNAP":
        what, queue = "nonlinear ACE", kl.QUEUE_ACE
    elif bs.chemflag or bs.quadraticflag:
        what, queue = "chemflag and quadraticflag networks", kl.QUEUE_CHEM
    elif max(int(x) for x in bs.twojmax) > F32_TWOJMAX:
        what, queue = f"twojmax {max(int(x) for x in bs.twojmax)}", \
            kl.QUEUE_LARGE
    elif mode not in ("auto", "cached", "otf"):
        what, queue = f"dgrad_mode {mode}", kl.QUEUE_NN
    else:
        return
    raise kl.f32_refusal(f"--dtype float32: {what}", queue)


def pas_chunk(calculator, a_pad, k_pad):
    """Configs of one `nn_desc` call of the PAS prep at an (A, K) shape: on
    SNAP, where K9 forms B alone, at most 32 configs or 1,024 atom slots
    (JAX `_prepare_pas`); on ACE, whose K14 forms dB/dD beside B, also
    `chunk_size`'s bound on that transient."""
    from fitsnap_tpu_torch.calculators.snap import chunk_size

    ace = getattr(calculator, "params", None) is None
    return chunk_size(a_pad, k_pad, calculator.desc_width() if ace else 1)


def _real_sums(B, real):
    """The standardization's sums of a bucket's descriptors B (n, A, W) over
    its real atoms (n, A): (sum B, sum B^2) (W,), summed at B's type and
    widened to float64 on the host (the buckets add at float64, as in the
    JAX package), and the count."""
    Bm = B * real[..., None]
    return (Bm.sum((0, 1)).cpu().numpy().astype(np.float64),
            (Bm * Bm).sum((0, 1)).cpu().numpy().astype(np.float64),
            int(real.sum()))


def _totals(stats):
    """The buckets' `_real_sums`, added in bucket order."""
    return [sum(x) for x in zip(*stats)]


def _truths(datas, nat, a_pad):
    """Energies (n,) and forces (n, a_pad, 3) of a bucket's configs."""
    e_t = np.array([d["Energy"] for d in datas], np.float64)
    f_t = np.zeros((len(datas), a_pad, 3))
    for j, d in enumerate(datas):
        f_t[j, :nat[j]] = d["Forces"]
    return e_t, f_t


def _config_meta(datas, dev):
    """A bucket's per-config weights, test flags, groups and files."""
    return {
        "ew": torch.tensor([d.get("eweight", 1.0) for d in datas],
                           dtype=DTYPE, device=dev),
        "fw": torch.tensor([d.get("fweight", 1.0) for d in datas],
                           dtype=DTYPE, device=dev),
        "test": np.array([bool(d["test_bool"]) for d in datas]),
        "groups": [d["Group"] for d in datas],
        "files": [str(d.get("File", "")) for d in datas],
    }


def _net_section(config):
    for name in ("PYTORCH", "NETWORK", "JAX"):
        if name in config.sections:
            return config.sections[name]
    raise ValueError("NN solver requires a PYTORCH/NETWORK/JAX section")


def _plateau_step_host(sched, metric, *, factor, patience, threshold,
                       lr_min, eps=1e-8):
    """One ReduceLROnPlateau update (torch semantics: mode=min,
    threshold_mode=abs, cooldown=0); sched = (lr, best, bad epochs).  A
    metric improves iff it beats the best by more than `threshold`; after
    `patience` epochs without improvement the LR is multiplied by `factor`
    (floored at `lr_min`, skipped below `eps`) and the count resets."""
    lr, best, bad = sched
    improved = metric < best - threshold
    best = metric if improved else best
    bad = 0 if improved else bad + 1
    trip = bad > patience
    new_lr = max(lr * factor, lr_min)
    if trip and (lr - new_lr > eps):
        lr = new_lr
    if trip:
        bad = 0
    return (lr, best, bad)


class Adam:
    """optax.scale_by_adam (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) with
    the update p + (-lr) u, as the JAX package applies its learning rate
    outside the transform.  State: count, mu and nu per parameter, saved as
    optax's flat leaf list (count, mu leaves, nu leaves)."""

    def __init__(self, params):
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, params, grads, lr):
        self.count += 1
        c1 = 1 - ADAM_B1 ** self.count
        c2 = 1 - ADAM_B2 ** self.count
        for i, (p, g) in enumerate(zip(params, grads)):
            self.mu[i] = (1 - ADAM_B1) * g + ADAM_B1 * self.mu[i]
            self.nu[i] = (1 - ADAM_B2) * (g ** 2) + ADAM_B2 * self.nu[i]
            u = (self.mu[i] / c1) / (torch.sqrt(self.nu[i] / c2) + ADAM_EPS)
            p.copy_(p + (-lr) * u)

    def clone(self):
        other = Adam([])
        other.count = self.count
        other.mu = [m.clone() for m in self.mu]
        other.nu = [v.clone() for v in self.nu]
        return other

    def leaves(self):
        return ([np.asarray(self.count, np.int32)]
                + [m.cpu().numpy() for m in self.mu]
                + [v.cpu().numpy() for v in self.nu])

    def load(self, stored, what):
        want = self.leaves()
        stored = list(stored)
        if len(stored) != len(want) or any(
                np.shape(a) != np.shape(b) for a, b in zip(stored, want)):
            raise ValueError(
                f"save_state_input {what!r} optimizer state does not match "
                "this fit's optimizer (shape mismatch)")
        n = len(self.mu)
        self.count = int(np.asarray(stored[0]))
        # at the parameters' type, whatever type the state was saved at
        self.mu = [torch.as_tensor(np.asarray(a), device=m.device)
                   .to(m.dtype) for a, m in zip(stored[1:1 + n], self.mu)]
        self.nu = [torch.as_tensor(np.asarray(a), device=v.device)
                   .to(v.dtype) for a, v in zip(stored[1 + n:], self.nu)]


class NetworkSolver(Solver):
    def __init__(self, name, config, device=None):
        super().__init__(name, config, linear=False)
        self.device = resolve_device(device)
        self.net = _net_section(config)
        # the custom pairwise NN (takes precedence over dgrad_mode)
        self.pairwise = "CUSTOM" in config.sections
        # per-atom-scalar fitting (reference lib/neural_networks/pas.py):
        # one scalar per atom, no energy contraction and no forces
        self.pas = config.sections["CALCULATOR"].per_atom_scalar
        self.buckets = None     # list of per-bucket dataset dicts
        self.mean = None
        self.std = None
        self.model = None
        self.cached = False     # dgrad_mode resolved to cached
        self.otf = False        # dgrad_mode resolved to otf
        # the working type (`--dtype`): float64, or float32 for the cached
        # and OTF modes of linear SNAP networks (`refuse_float32`, which
        # `FitSnap` calls before it builds anything)
        self.dtype = working_type(config.args)
        self._kit = None        # calculators/snap.nn_kit of the fit
        self._snap = None       # its SnapParams (None for ACE)
        self._dense = None      # the OTF minibatch's B and dB/dD, no kit
        self._cutoff = None     # the neighbor cutoff of the cached/OTF lists
        self._custom = None     # the pairwise mode's [CUSTOM] section
        self.history = []
        self.lr_history = np.zeros(0)
        self.final_lr = None
        self.epoch_times = []

    # ------------- data -------------

    def prepare_dataset(self, calculator, data):
        """The training set on the device, with the reference-subtracted
        targets and the descriptor standardization, in the mode
        `dgrad_mode` resolves to (JAX `prepare_dataset`): `auto` takes the
        cached mode for linear SNAP while its cache stays within
        NEIGH_LIMIT, else precompute while dB/dD stays within G_LIMIT, else
        OTF; `cached` where its kit does not apply (chemflag,
        quadraticflag, ACE) warns and takes OTF.  A [CUSTOM] section takes
        the pairwise mode, and `per_atom_scalar` the PAS mode, whatever
        `dgrad_mode` says."""
        from fitsnap_tpu_torch.calculators.snap import (
            chunk_size, coalesce_shape_buckets, pack_bucket)
        from fitsnap_tpu_torch.parallel.fit import plan_pos_buckets

        self.cached = self.otf = False
        mode = self.net.dgrad_mode
        if self.pairwise:
            return self._prepare_pairwise(calculator, data)
        if self.pas:
            return self._prepare_pas(calculator, data)
        if mode in ("auto", "cached", "otf"):
            packed = [calculator._pack(d) for d in data]
            pos_groups = plan_pos_buckets(
                packed, calculator.cutoff,
                max_programs=plan_var("NN_MAX_PROGRAMS", MAX_PROGRAMS))
            kit = calculator.nn_analytic()
            if mode == "auto":
                # pairs: disp + jidx + mask; atoms: the cached ut and B; at
                # the working type's size
                itemsz = self.dtype.itemsize
                neigh_bytes = sum(
                    len(g["configs"]) * g["a_pad"]
                    * (min(g["k_pad"], g["a_pad"] * len(g["s_table"]))
                       * (3 * itemsz + 5) + 2600) for g in pos_groups)
                g_bytes = sum(len(g["configs"]) * g["a_pad"] * g["k_pad"]
                              * calculator.get_width() * 3 * itemsz
                              for g in pos_groups)
                if kit is not None and neigh_bytes <= plan_var(
                        "NN_NEIGH_LIMIT", NEIGH_LIMIT):
                    mode = "cached"
                elif g_bytes <= plan_var("NN_G_LIMIT", G_LIMIT):
                    mode = "precompute"
                else:
                    mode = "otf"
                screen(f"dgrad_mode=auto -> {mode} (neighbor cache "
                       f"{neigh_bytes / 1e9:.3f} GB, dB/dD "
                       f"{g_bytes / 1e9:.3f} GB)")
            if mode == "cached" and kit is None:
                warn("dgrad_mode=cached is not available for this "
                     "descriptor config (chem/quadratic/non-SNAP); "
                     "falling back to otf")
                mode = "otf"
        refuse_float32(self.config, mode, self.dtype)
        self.cached, self.otf = mode == "cached", mode == "otf"
        if self.cached or self.otf:
            # SNAP's model, or None for ACE
            self._snap = getattr(calculator, "params", None)
            self._cutoff = float(calculator.cutoff)
            # the descriptor form picks the OTF route: the pair-grid kit for
            # one element channel (quadraticflag too); B and dB/dD of each
            # minibatch under chemflag (K1-K3) and for ACE (K13, K14)
            dense = self._snap is None or self._snap.chemflag
            self._kit = None if dense else calculator.nn_kit()
            self._dense = calculator.nn_descriptors if dense else None
            return self._prepare_pos(calculator, pos_groups)
        packed, shape_buckets = calculator.host_preprocess(data)
        shape_buckets = coalesce_shape_buckets(shape_buckets)
        width = calculator.desc_width()

        dev = self.device
        self.buckets = []
        stats = []
        for (a_pad, k_pad), idxs in sorted(shape_buckets.items()):
            n = len(idxs)
            arrays = pack_bucket(packed, idxs, a_pad, k_pad)
            disp, jidx, mask, rev, types, nat, _ = arrays
            datas = [packed[i].data for i in idxs]
            e_t, f_t = _truths(datas, nat, a_pad)
            chunk = min(chunk_size(a_pad, k_pad, width), n)
            outs = []
            for c0 in range(0, n, chunk):
                outs.append(calculator.nn_prep(*[
                    torch.from_numpy(x[c0:c0 + chunk]).to(dev)
                    for x in arrays[:6]]))
            B, G, re, rf = (torch.cat(x) for x in zip(*outs))
            del outs
            natd = torch.from_numpy(nat).to(dev)
            e_target = (torch.from_numpy(e_t).to(dev) - re) \
                / torch.clamp(natd, min=1)
            f_target = torch.from_numpy(f_t).to(dev) - rf
            real = torch.arange(a_pad, device=dev)[None, :] < natd[:, None]
            stats.append(_real_sums(B, real))
            self.buckets.append({
                "B": B, "G": G,
                "jidx": torch.from_numpy(jidx).to(dev),
                "rev": torch.from_numpy(rev).to(dev),
                "types": torch.from_numpy(types).to(dev),
                "nat": natd, "real": real,
                "e_target": e_target, "f_target": f_target,
                "nat_host": nat, "shape": (a_pad, k_pad),
                **_config_meta(datas, dev),
            })
        self._standardize(*_totals(stats))
        return self.buckets

    def _standardize(self, sum_b, sumsq_b, count):
        """mean and std of the descriptors from their float64 sums, at the
        working type."""
        mean = sum_b / count
        var = sumsq_b / count - mean ** 2
        std = np.sqrt(np.clip(var, 0, None))
        std[std < 1e-8] = 1.0
        self.mean = torch.as_tensor(mean, device=self.device).to(self.dtype)
        self.std = torch.as_tensor(std, device=self.device).to(self.dtype)

    def _prepare_pos(self, calculator, pos_groups):
        """The cached and OTF modes' buckets (JAX `_prepare_otf`, with
        `cache=True` in the cached mode) on one device.  Per bucket of
        `plan_pos_buckets` the positions go to the device (`pack_batch_pos`
        at the working type: float32 as hi/lo parts, with the truths and
        weights), and per chunk of configs K8 builds the neighbor lists, K8r
        their reverse table, the descriptor pass B (cached: K9's ut and B;
        OTF: `nn_desc`, K9 with the quadratic columns, or under chemflag
        K1-K3's chemflag modes and for ACE K13 and K14, whose dB/dD is
        dropped), and K5 the
        reference potential; the stats pass forms the targets and the
        standardization over real atoms.  A cached bucket keeps disp, jidx,
        mask, rev, ut and B, not the positions (they never move in
        training); an OTF bucket keeps the positions alone.  The reverse
        tables' dropped entries are checked here once: a step's lists
        equal these."""
        from fitsnap_tpu_torch.calculators.snap import chunk_size
        from fitsnap_tpu_torch.kernels import snap_kernels as sk
        from fitsnap_tpu_torch.ops.refpot import reference_eav
        from fitsnap_tpu_torch.parallel.fit import (_check_dropped,
                                                    pack_batch_pos)

        dev, cutoff = self.device, self._cutoff
        self.buckets = []
        stats = []
        for g in pos_groups:
            cfgs, a_pad, s_table = g["configs"], g["a_pad"], g["s_table"]
            n, S = len(cfgs), len(s_table)
            k_pad = int(min(g["k_pad"], a_pad * S))
            ph, pl, sh, sl, types, nat, _, e_t, f_t, _, ew, fw, _ = (
                torch.from_numpy(x[0]).to(dev)
                for x in pack_batch_pos(
                    cfgs, a_pad, n, s_table,
                    np.float32 if self.dtype == torch.float32
                    else np.float64))
            # bound the (A, S, A) neighbor-candidate transient (and the
            # chunk's dB/dD on the dense route)
            chunk = int(min(32, max(1, (1 << 26) // (a_pad * S * a_pad)), n))
            if self._dense is not None:
                chunk = min(chunk, chunk_size(a_pad, k_pad,
                                              calculator.desc_width()))
            outs = []
            for c0 in range(0, n, chunk):
                c = slice(c0, c0 + chunk)
                disp, jidx, mask = sk.device_neighbors(
                    ph[c], pl[c], sh[c], sl[c], nat[c], cutoff, k_pad)
                rev, dropped = sk.reverse_table(jidx, mask)
                keep = ()
                if self.cached:
                    ut, B = self._kit["utb"](disp, jidx, mask, types[c],
                                             nat[c])
                    keep = (disp, jidx, mask, rev, ut)
                elif self._dense is not None:
                    B = self._dense(disp, jidx, mask, types[c], nat[c])[0]
                else:
                    B = calculator.nn_desc(disp, jidx, mask, types[c], nat[c])
                re, rf, _ = reference_eav(disp, jidx, mask, rev, types[c],
                                          calculator.refspec)
                outs.append((B, re, rf, dropped) + keep)
            B, re, rf, dropped, *keep = (torch.cat(x) for x in zip(*outs))
            del outs
            _check_dropped(dropped)
            real = torch.arange(a_pad, device=dev)[None, :] < nat[:, None]
            stats.append(_real_sums(B, real))
            if self.cached:
                lists = dict(zip(("disp", "jidx", "mask", "rev", "ut"), keep),
                             B=B)
            else:
                lists = {"pos_hi": ph, "pos_lo": pl, "svec_hi": sh,
                         "svec_lo": sl}
            self.buckets.append({
                **lists, "types": types, "elem": types.clone(),
                "nat": nat, "real": real,
                "e_target": (e_t - re) / torch.clamp(nat, min=1),
                "f_target": f_t - rf, "ew": ew, "fw": fw,
                "test": np.array([bool(pc.data["test_bool"]) for pc in cfgs]),
                "groups": [pc.data["Group"] for pc in cfgs],
                "files": [str(pc.data.get("File", "")) for pc in cfgs],
                "nat_host": nat.cpu().numpy(), "shape": (a_pad, k_pad),
            })
        self._standardize(*_totals(stats))
        return self.buckets

    def _prepare_pairwise(self, calculator, data):
        """The pairwise mode's buckets (JAX `_prepare_pairwise`): per shape
        bucket the host neighbor lists, with their reverse tables, go to the
        device, with the raw per-atom energy and force targets (no
        reference potential is subtracted); the standardization sums over
        the live pairs' descriptors run K15 on the device, PAIR_CHUNK slots
        at a time."""
        from fitsnap_tpu_torch.calculators.snap import (coalesce_shape_buckets,
                                                        pack_bucket)

        packed, shape_buckets = calculator.host_preprocess(data)
        shape_buckets = coalesce_shape_buckets(shape_buckets)
        sec = self._custom = calculator.sec
        dev = self.device
        self.buckets = []
        sum_b = sumsq_b = 0.0
        count = 0
        for (a_pad, k_pad), idxs in sorted(shape_buckets.items()):
            n = len(idxs)
            disp, jidx, mask, rev, types, nat, _ = pack_bucket(
                packed, idxs, a_pad, k_pad)
            datas = [packed[i].data for i in idxs]
            e_t, f_t = _truths(datas, nat, a_pad)
            disp = torch.from_numpy(disp).to(dev)
            mask = torch.from_numpy(mask).to(dev)
            chunk = max(1, PAIR_CHUNK // (a_pad * k_pad))
            for c0 in range(0, n, chunk):
                desc, _ = pair_desc(disp[c0:c0 + chunk], mask[c0:c0 + chunk],
                                    sec.cutoff, sec.num_radial,
                                    sec.num_3body)
                sum_b = sum_b + desc.sum((0, 1, 2)).cpu().numpy()
                sumsq_b = sumsq_b + (desc * desc).sum((0, 1, 2)).cpu().numpy()
            count += int(mask.sum())
            natd = torch.from_numpy(nat).to(dev)
            self.buckets.append({
                "disp": disp, "mask": mask,
                "jidx": torch.from_numpy(jidx).to(dev),
                "rev": torch.from_numpy(rev).to(dev),
                "types": torch.from_numpy(types).to(dev),
                "nat": natd,
                "real": torch.arange(a_pad, device=dev)[None, :]
                < natd[:, None],
                "e_target": torch.from_numpy(e_t).to(dev)
                / torch.clamp(natd, min=1),
                "f_target": torch.from_numpy(f_t).to(dev),
                "nat_host": nat, "shape": (a_pad, k_pad),
                **_config_meta(datas, dev),
            })
        self._standardize(sum_b, sumsq_b, count)
        return self.buckets

    def _prepare_pas(self, calculator, data):
        """The PAS buckets (JAX `_prepare_pas`): per shape bucket of the
        host neighbor lists, the per-atom descriptors B of `nn_desc` on the
        device (zero on padded atoms), chunk by chunk, and the per-atom
        targets of the configs' `Chis`; the standardization sums over real
        atoms.  No reference potential is subtracted."""
        from fitsnap_tpu_torch.calculators.snap import (coalesce_shape_buckets,
                                                        pack_bucket)

        packed, shape_buckets = calculator.host_preprocess(data)
        shape_buckets = coalesce_shape_buckets(shape_buckets)
        dev = self.device
        self.buckets = []
        stats = []
        for (a_pad, k_pad), idxs in sorted(shape_buckets.items()):
            n = len(idxs)
            disp, jidx, mask, _, types, nat, _ = pack_bucket(
                packed, idxs, a_pad, k_pad)
            datas = [packed[i].data for i in idxs]
            chis = np.zeros((n, a_pad))
            for j, d in enumerate(datas):
                chis[j, :nat[j]] = np.asarray(d["Chis"],
                                              np.float64).reshape(-1)
            chunk = min(pas_chunk(calculator, a_pad, k_pad), n)
            B = torch.cat([calculator.nn_desc(*[
                torch.from_numpy(x[c0:c0 + chunk]).to(dev)
                for x in (disp, jidx, mask, types, nat)])
                for c0 in range(0, n, chunk)])
            natd = torch.from_numpy(nat).to(dev)
            real = torch.arange(a_pad, device=dev)[None, :] < natd[:, None]
            stats.append(_real_sums(B, real))
            meta = _config_meta(datas, dev)
            del meta["fw"]
            self.buckets.append({
                "B": B, "types": torch.from_numpy(types).to(dev),
                "nat": natd, "real": real,
                "pas_target": torch.from_numpy(chis).to(dev),
                "nat_host": nat, "shape": (a_pad, k_pad), **meta,
            })
        self._standardize(*_totals(stats))
        return self.buckets

    # ------------- model -------------

    def _forward_batch(self, model, batch, train=False):
        """Per-atom-normalized energies and forces of one gathered batch
        under `model` (a `PerElementMLP`).  With `train`, dE/dB keeps its
        graph and the forces go through `NnForce`, so the loss's parameter
        gradient holds the force term."""
        B = batch["B"]
        real = batch["real"].to(B.dtype)
        nat = torch.clamp(batch["nat"], min=1).to(B.dtype)
        x = ((B - self.mean) / self.std).requires_grad_(True)
        with torch.enable_grad():
            e = (model(x, batch["types"]) * real).sum(1)
            dEdx, = torch.autograd.grad(e.sum(), x, create_graph=train)
        dEdB = dEdx / self.std
        if train:
            forces = NnForce.apply(dEdB, batch["G"], batch["jidx"],
                                   batch["rev"])
        else:
            e, dEdB = e.detach(), dEdB.detach()
            forces = nn_force(dEdB, batch["G"], batch["jidx"], batch["rev"])
        return e / nat, forces

    def _forward_batch_cached(self, model, batch, train=False):
        """The cached mode's energies and forces of one gathered batch (JAX
        `_forward_batch_cached`): the MLP on the cached B over the flattened
        (configs x atoms) axis, then dE/dB taken to the pairs and gathered
        into forces (K2, K10, K11 and the gather; with `train`, through
        `NnCachedForce`, whose backward K11T, K10T carries the force term
        into the loss's parameter gradient).  Under quadraticflag (the OTF
        mode) the MLP sees B with its quadratic columns, whose dE/dB folds
        back onto the base columns ahead of K10 (`ops/snap.quad_fold`)."""
        kit, p = self._kit, self._snap
        B = batch["B"]
        N, A, W = B.shape
        B = B.reshape(N * A, W)
        real = batch["real"].to(B.dtype).reshape(-1)
        nat = torch.clamp(batch["nat"], min=1).to(B.dtype)
        x = ((_quad_extend(B, p) - self.mean) / self.std).requires_grad_(True)
        with torch.enable_grad():
            e = (model(x, batch["elem"].reshape(-1)) * real).reshape(N, A) \
                .sum(1)
            dEdx, = torch.autograd.grad(e.sum(), x, create_graph=train)
        dEdB = quad_fold(dEdx / self.std, B, p)
        ut = batch["ut"].reshape(N * A, -1)
        disp, types = batch["disp"], batch["types"]
        pair = kit["pair"](disp, batch["jidx"], batch["mask"], types)
        if train:
            K = disp.shape[2]
            jelem, smask = pair
            forces = NnCachedForce.apply(
                dEdB, ut, disp.reshape(N * A, K, 3), batch["jidx"],
                jelem.reshape(N * A, K), smask.reshape(N * A, K),
                types.reshape(N * A), batch["rev"], self._snap)
        else:
            e, dEdB = e.detach(), dEdB.detach()
            g = kit["force"](kit["dEdu_vg"](dEdB, ut), disp, pair, types)
            forces = nn_pair_gather(g, batch["rev"])
        return e / nat, forces

    def _forward_batch_otf(self, model, batch, train=False):
        """The OTF mode's energies and forces of one gathered batch (JAX
        `_forward_batch_otf`, with analytic forces in place of autodiff in
        the positions): the neighbor lists rebuilt from the positions (K8,
        K8r), then by the descriptor form.  One element channel (linear
        SNAP, quadraticflag): K9's ut and B into the cached step
        (`_forward_batch_cached`).  chemflag and ACE: B and dB/dD of the
        minibatch from K1-K3's chemflag modes or from K13 and K14 into the
        precompute step (`_forward_batch`); that dB/dD lives for this step
        only."""
        from fitsnap_tpu_torch.kernels import snap_kernels as sk

        types, nat = batch["types"], batch["nat"]
        disp, jidx, mask = sk.device_neighbors(
            batch["pos_hi"], batch["pos_lo"], batch["svec_hi"],
            batch["svec_lo"], nat, self._cutoff, batch["shape"][1])
        rev, _ = sk.reverse_table(jidx, mask)
        if self._kit is None:
            B, G = self._dense(disp, jidx, mask, types, nat)
            return self._forward_batch(model, dict(
                batch, B=B, G=G, types=batch["elem"], jidx=jidx, rev=rev),
                train)
        ut, B = self._kit["utb"](disp, jidx, mask, types, nat)
        return self._forward_batch_cached(model, dict(
            batch, disp=disp, jidx=jidx, mask=mask, rev=rev, ut=ut, B=B),
            train)

    def _forward_pairwise(self, model, batch, train=False):
        """The pairwise mode's energies and forces of one gathered batch
        (JAX `_forward_pairwise`): K15's pair descriptors and envelope fc,
        the MLP per pair with atom i's element over the flattened (configs
        x atoms x slots) axis, the energy sum of e_pair fc over live pairs,
        and the forces from dE/d(descriptor) and the pair energies through
        K15V and the gather (with `train`, through `PairDescForce`, whose
        backward K15T carries the force term into the loss's parameter
        gradient)."""
        sec = self._custom
        R, M = sec.num_radial, sec.num_3body
        disp, mask = batch["disp"], batch["mask"]
        N, A, K, _ = disp.shape
        desc, fc = pair_desc(disp, mask, sec.cutoff, R, M)
        nat = torch.clamp(batch["nat"], min=1).to(desc.dtype)
        x = ((desc - self.mean) / self.std).reshape(N * A * K, R + M) \
            .requires_grad_(True)
        elem = batch["types"][:, :, None].expand(N, A, K).reshape(-1)
        with torch.enable_grad():
            e_pair = model(x, elem).reshape(N, A, K)
            e = (e_pair * fc).sum((1, 2))
            dEdx, = torch.autograd.grad(e.sum(), x, create_graph=train)
        g_desc = (dEdx / self.std).reshape(N, A, K, R + M)
        e_env = e_pair * mask.to(e_pair.dtype)
        if train:
            forces = PairDescForce.apply(g_desc, e_env, disp, mask,
                                         batch["jidx"], batch["rev"],
                                         sec.cutoff, R, M)
        else:
            e = e.detach()
            g = pair_desc_vjp(g_desc.detach().contiguous(),
                              e_env.detach().contiguous(), disp, mask,
                              sec.cutoff, R, M)
            forces = nn_pair_gather(g, batch["rev"])
        return e / nat, forces

    def _forward_pas(self, model, batch, train=False):
        """Per-atom scalars (N, A) of one gathered batch (JAX
        `_forward_pas`): the MLP on the standardized B, one evaluation an
        atom, zero on padded atoms; no contraction, no forces.  Without
        `train` the scalars keep no graph."""
        B = batch["B"]
        x = (B - self.mean) / self.std
        with torch.set_grad_enabled(train):
            return model(x, batch["types"]) * batch["real"].to(B.dtype)

    def _forward(self):
        return (self._forward_pas if self.pas
                else self._forward_pairwise if self.pairwise
                else self._forward_batch_cached if self.cached
                else self._forward_batch_otf if self.otf
                else self._forward_batch)

    def _counts(self, ds, idx):
        """The normalizers of the loss of minibatch `idx` of bucket `ds`,
        from the host's atom counts: PAS, its real atoms; else its live
        configs and their force components; each at least 1."""
        nat = np.asarray(ds["nat_host"])[np.asarray(idx)]
        if self.pas:
            return max(float(nat.sum()), 1.0)
        return (max(float((nat > 0).sum()), 1.0),
                max(3.0 * float(nat.sum()), 1.0))

    def _loss(self, model, batch, train=False, counts=None):
        """Weighted MSE loss of one minibatch (JAX `_loss`); PAS: the
        weighted per-atom residuals over the real atoms.  `counts`, the
        normalizers of `_counts`, default to the batch's own; under a
        process group `batch` is this rank's share and `counts` the whole
        minibatch's, so the group's sum of these losses is the whole
        minibatch's loss."""
        net = self.net
        if self.pas:
            pred = self._forward_pas(model, batch, train)
            real = batch["real"].to(pred.dtype)
            res = (pred - batch["pas_target"]) * real
            na = torch.clamp(real.sum(), min=1.0) if counts is None \
                else counts
            return torch.sum(batch["ew"][:, None] * res ** 2) / na
        e_pred, f_pred = self._forward()(model, batch, train)
        real = batch["real"].to(e_pred.dtype)
        live = (batch["nat"] > 0).to(e_pred.dtype)
        if counts is None:
            ne = torch.clamp(live.sum(), min=1.0)
            nfc = torch.clamp((real.sum(1) * 3 * live).sum(), min=1.0)
        else:
            ne, nfc = counts
        e_res = (e_pred - batch["e_target"]) * live
        f_res = (f_pred - batch["f_target"]) * real[..., None] \
            * live[:, None, None]
        if net.global_weight_bool:
            return (net.energy_weight * torch.sum(e_res ** 2) / ne
                    + net.force_weight * torch.sum(f_res ** 2) / nfc)
        return (torch.sum(batch["ew"] * e_res ** 2) / ne
                + torch.sum(batch["fw"][:, None, None] * f_res ** 2) / nfc)

    def _gather(self, ds, idx):
        idx = torch.as_tensor(np.asarray(idx), dtype=torch.long,
                              device=self.device)
        keys = (_BATCH_KEYS_PAS if self.pas
                else _BATCH_KEYS_PW if self.pairwise
                else _BATCH_KEYS_CACHED if self.cached
                else _BATCH_KEYS_OTF if self.otf else _BATCH_KEYS)
        return dict({k: ds[k].index_select(0, idx) for k in keys},
                    shape=ds["shape"])

    # ------------- training -------------

    def perform_fit(self, a=None, b=None, w=None, fs_dict=None,
                    calculator=None, data=None):
        if self.buckets is None:
            assert calculator is not None and data is not None, \
                "NetworkSolver needs (calculator, data) or prepare_dataset()"
            self.prepare_dataset(calculator, data)
        net = self.net
        dev = self.device
        sections = self.config.sections
        desc_sec = (sections.get("BISPECTRUM") or sections.get("ACE")
                    or sections.get("CUSTOM"))
        nelem_net = desc_sec.numtypes if net.multi_element_option == 2 else 1
        if net.multi_element_option != 2:
            for ds in self.buckets:
                # cached buckets carry the network index apart ("elem"):
                # the descriptor side needs the true atom types
                key = "elem" if "elem" in ds else "types"
                ds[key] = torch.zeros_like(ds[key])
        W = world()[1]
        seed = 13 if net.manual_seed_flag else int(time.time()) % 2 ** 31
        seed = int(from_rank_zero(seed, dev))   # every rank's is rank 0's
        if net.layer_sizes[0] == 0:
            # the 'num_desc' placeholder unresolved at config time (ACE,
            # whose width the plan gives): the prepared descriptors' width
            net.layer_sizes[0] = int(self.mean.shape[0])
        params = init_mlp(net.layer_sizes, nelem_net,
                          torch.Generator().manual_seed(seed), dev,
                          self.dtype)
        warm_start = net.save_state_input and net.save_state_input != "None"
        warm_opt = None
        if warm_start:
            params, warm_opt = self._warm_start(net, params)
        # start the output bias at the mean per-atom energy target (PAS: the
        # mean real-atom target)
        if self.pas:
            e_mean = float(np.concatenate(
                [ds["pas_target"][ds["real"]].cpu().numpy()
                 for ds in self.buckets]).mean())
        else:
            e_mean = float(np.mean(np.concatenate(
                [ds["e_target"].cpu().numpy() for ds in self.buckets])))
        if self.pairwise:
            # pairwise models sum per-pair energies: scale by pairs per atom
            pairs = sum(float(ds["mask"].sum()) for ds in self.buckets)
            atoms = sum(float(ds["nat_host"].sum()) for ds in self.buckets)
            e_mean = e_mean / max(pairs / max(atoms, 1.0), 1.0)
        if not warm_start:
            w_last, b_last = params[-1]
            params[-1] = (w_last, b_last + e_mean)
        model = PerElementMLP(params)
        leaves = list(model.parameters())
        adam = Adam(leaves)
        if warm_opt is not None:
            adam.load(warm_opt, net.save_state_input)
        sched_on = bool(getattr(net, "lr_plateau_flag", False))

        # per-bucket train/val indices and the minibatch plan of every
        # epoch, drawn in the JAX package's order
        rng = np.random.default_rng(13)
        bs = net.batch_size
        train_sets, val_sets = [], []
        for ds in self.buckets:
            tr = np.where(~ds["test"])[0]
            va = np.where(ds["test"])[0]
            if net.training_fraction < 1.0 and len(va) == 0:
                ntr = int(len(tr) * net.training_fraction)
                va = tr[ntr:]
                tr = tr[:ntr]
            train_sets.append(tr)
            val_sets.append(va)
        def plan_bsz(n, ds):
            """The minibatch size (JAX `_plan_bsz`, in its order):
            min(batch_size, n); with ATOMS_PER_BATCH, grown to that many
            atom slots and then held to APB_PAIRS pair slots (the PAS
            buckets keep no slots); at most OTF_CANDIDATES neighbor
            candidates in the OTF mode and CACHED_PAIRS pair slots in the
            cached mode, but at least W; then a multiple of the W
            processes."""
            if W > 1 and bs < W:
                raise ValueError(
                    f"batch_size={bs} < devices={W}: data-parallel "
                    "training needs at least one example per device per "
                    "minibatch — raise batch_size or lower --devices")
            bsz = min(bs, n)
            a_pad, k_pad = ds["shape"]
            apb = plan_var("NN_ATOMS_PER_BATCH", ATOMS_PER_BATCH)
            if apb:
                bsz = min(n, max(bsz, apb // max(a_pad, 1)))
                if not self.pas:
                    bsz = min(bsz, max(1, APB_PAIRS // (a_pad * k_pad)))
            if self.otf:
                S = ds["svec_hi"].shape[1]
                cap = max(1, OTF_CANDIDATES // (a_pad * S * a_pad))
                bsz = min(bsz, max(cap, W))
            if self.cached:
                cap = max(1, plan_var("NN_PAIRS", CACHED_PAIRS)
                          // (a_pad * k_pad))
                bsz = min(bsz, max(cap, W))
            if W > 1:
                bsz = W * max(1, bsz // W)
            return bsz

        E = net.num_epochs
        train_perms, tkeys = [], []
        for bi, tr in enumerate(train_sets):
            if len(tr) == 0:
                continue
            bsz = plan_bsz(len(tr), self.buckets[bi])
            if len(tr) < bsz:          # fewer examples than processes: wrap
                tr = np.resize(tr, bsz)
            nst = (len(tr) - bsz) // bsz + 1
            train_perms.append(np.stack([
                (rng.permutation(tr) if net.shuffle_flag else np.asarray(tr))
                [:nst * bsz].reshape(nst, bsz) for _ in range(E)]))
            tkeys.append(bi)
        val_plans, vkeys = [], []
        for bi, va in enumerate(val_sets):
            if len(va) == 0:
                continue
            bsz = plan_bsz(len(va), self.buckets[bi])
            va = np.asarray(va)
            if len(va) < bsz:
                va = np.resize(va, bsz)
            nst = (len(va) - bsz) // bsz + 1
            val_plans.append(va[:nst * bsz].reshape(nst, bsz))
            vkeys.append(bi)

        def mine(idx):
            """This rank's contiguous share of a minibatch's indices."""
            return idx[share(len(idx), "minibatch examples")]

        sched = (float(net.learning_rate), np.inf, 0)
        best_val = np.inf
        best_leaves = [p.detach().clone() for p in leaves]
        best_opt = adam.clone()
        tls, vls, lrs = np.zeros(E), np.zeros(E), np.zeros(E)
        self.epoch_times = []
        for e in range(E):
            t0 = time.time()
            lr = sched[0]
            tl_sum = torch.zeros((), dtype=DTYPE, device=dev)
            tn = 0
            for slot, bi in enumerate(tkeys):
                losses = []
                ds = self.buckets[bi]
                for idx in train_perms[slot][e]:
                    loss = self._loss(model, self._gather(ds, mine(idx)),
                                      train=True,
                                      counts=self._counts(ds, idx))
                    *grads, loss = all_sum(
                        *torch.autograd.grad(loss, leaves), loss.detach())
                    adam.step(leaves, grads, lr)
                    losses.append(loss)
                tl_sum = tl_sum + torch.stack(losses).sum()
                tn += len(losses)
            tl = float(tl_sum / max(tn, 1))
            if vkeys:
                vl_sum = torch.zeros((), dtype=DTYPE, device=dev)
                vn = 0
                for slot, bi in enumerate(vkeys):
                    ds = self.buckets[bi]
                    vl_b = [self._loss(model, self._gather(ds, mine(idx)),
                                       counts=self._counts(ds, idx))
                            for idx in val_plans[slot]]
                    vl_sum = vl_sum + torch.stack(vl_b).sum()
                    vn += len(vl_b)
                vl_sum, = all_sum(vl_sum)
                vl = float(vl_sum / max(vn, 1))
            else:
                vl = tl
            if vl <= best_val:
                # torch parameters change in place: keep copies
                best_val = vl
                best_leaves = [p.detach().clone() for p in leaves]
                best_opt = adam.clone()
            if sched_on:
                sched = _plateau_step_host(
                    sched, vl, factor=net.lr_plateau_factor,
                    patience=net.lr_plateau_patience,
                    threshold=net.lr_plateau_threshold, lr_min=net.lr_min)
            tls[e], vls[e], lrs[e] = tl, vl, sched[0]
            self.epoch_times.append(time.time() - t0)
        self.final_lr = float(sched[0])
        self.lr_history = lrs
        self._log_lr_reductions(net)
        self.history = [(e, float(tls[e]), float(vls[e])) for e in range(E)]
        with torch.no_grad():
            for p, q in zip(leaves, best_leaves):
                p.copy_(q)
        self.model = model
        self.fit = None  # nonlinear: no coefficient vector
        return self._finalize_fit(best_opt, net, nelem_net)

    def _warm_start(self, net, params):
        """Parameters, standardization and Adam leaves of a saved state,
        checked against this fit's shapes and settings."""
        loaded, meta = load_params(net.save_state_input)
        got = [(tuple(w.shape), tuple(b.shape)) for w, b in loaded]
        want = [(tuple(w.shape), tuple(b.shape)) for w, b in params]
        if got != want:
            raise ValueError(
                f"save_state_input {net.save_state_input!r} has layer "
                f"shapes {got}, but this fit needs {want} "
                f"(layer_sizes/multi_element_option mismatch)")
        if meta.get("layer_sizes") is not None and \
                list(meta["layer_sizes"]) != list(net.layer_sizes):
            raise ValueError(
                f"save_state_input {net.save_state_input!r} was trained "
                f"with layer_sizes={meta['layer_sizes']}, this fit uses "
                f"{net.layer_sizes}")
        if meta.get("multi_element_option") not in (
                None, net.multi_element_option):
            raise ValueError(
                f"save_state_input {net.save_state_input!r} was trained "
                f"with multi_element_option="
                f"{meta['multi_element_option']}, this fit uses "
                f"{net.multi_element_option}")

        # the saved state at this fit's type, as the JAX package casts it
        params = mlp_params_from_numpy(loaded, self.device, self.dtype)
        # the saved weights were trained against the saving fit's
        # descriptor standardization: restore it
        if meta.get("mean") is not None and self.mean is not None:
            m, s = np.asarray(meta["mean"]), np.asarray(meta["std"])
            if m.shape != tuple(self.mean.shape):
                raise ValueError(
                    f"save_state_input {net.save_state_input!r} has "
                    f"descriptor mean of width {m.shape}, this fit "
                    f"computes {tuple(self.mean.shape)}")
            self.mean, self.std = (torch.as_tensor(x, dtype=self.dtype,
                                                   device=self.device)
                                   for x in (m, s))
        return params, meta.get("opt_state")

    def _log_lr_reductions(self, net):
        """Make scheduler action visible in run output: the reference's
        effective trajectory is constant-LR (it never steps its scheduler),
        so any reduction here is a deliberate divergence the user opted
        into with lr_plateau_flag=1."""
        if self.lr_history.size and self.final_lr is not None \
                and self.final_lr < float(net.learning_rate) * (1 - 1e-12):
            first = int(np.argmax(
                self.lr_history < float(net.learning_rate) * (1 - 1e-12)))
            info(f"ReduceLROnPlateau: lr {float(net.learning_rate):g} -> "
                 f"{self.final_lr:g} (first reduction at epoch {first}; "
                 "the reference never steps its scheduler)")

    def _finalize_fit(self, best_opt, net, nelem_net):
        with open_output("loss_vs_epochs.dat") as f:
            for e, tl, vl in self.history:
                f.write(f"{e} {tl:.8e} {vl:.8e}\n")
        mean, std = self.mean.cpu().numpy(), self.std.cpu().numpy()
        if net.save_state_output and net.save_state_output != "None":
            save_params(net.save_state_output, self.model.params, {
                "layer_sizes": net.layer_sizes, "mean": mean, "std": std,
                "multi_element_option": net.multi_element_option,
                # Adam moments at the best-val epoch (the saved params)
                "opt_state": best_opt.leaves(),
            })
        if net.output_file and net.output_file != "None":
            # LAMMPS ML-IAP deployment module (reference
            # `lib/neural_networks/pytorch.py:250`; pairwise: `pairwise.py:226`
            # -> `write.py:189 PairNN`)
            from fitsnap_tpu_torch.io.export_torch import (export_mliap,
                                                           export_pairnn)
            out = net.output_file
            if not out.endswith(".pt"):
                out += ".pt"
            params = params_to_numpy(self.model.params)
            if self.pairwise:
                sec = self._custom
                export_pairnn(out, params, mean, std, sec.cutoff,
                              sec.num_radial, sec.num_3body, nelem_net)
            else:
                export_mliap(out, params, mean, std, nelem_net)
        return self.model

    # ------------- evaluation / errors -------------

    def evaluate_bucket(self, ds):
        """Per-atom energies (n,) and forces (n, A, 3) of every config in
        one bucket, as numpy arrays, 32 configs at a time; PAS: the per-atom
        scalars (n, A) and None."""
        n = int(ds["nat"].shape[0])
        fwd = self._forward()
        if self.pas:
            return torch.cat([
                fwd(self.model,
                    self._gather(ds, np.arange(c0, min(c0 + 32, n))))
                for c0 in range(0, n, 32)]).cpu().numpy(), None
        es, fs = [], []
        for c0 in range(0, n, 32):
            e, f = fwd(self.model,
                       self._gather(ds, np.arange(c0, min(c0 + 32, n))))
            es.append(e)
            fs.append(f)
        return torch.cat(es).cpu().numpy(), torch.cat(fs).cpu().numpy()

    def _dump_details(self):
        """Per-config and per-atom prediction files (reference
        solver.py:210-298 NN dumps, consumed by tools/nn_tools.py)."""
        extras = self.config.sections["EXTRAS"]
        outfile = self.config.sections["OUTFILE"]
        fhc = open_output(outfile.perconfig_file) if extras.dump_perconfig \
            else None
        fha = open_output(outfile.peratom_file) if extras.dump_peratom \
            else None
        if fhc:
            fhc.write("Filename Group Natoms Energy_Truth Energy_Pred "
                      "Testing_Bool\n")
        if fha:
            fha.write("Filename Group AtomID Type Fx_Truth Fy_Truth "
                      "Fz_Truth Fx_Pred Fy_Pred Fz_Pred Testing_Bool\n")
        for ds in self.buckets:
            e_pred, f_pred = self.evaluate_bucket(ds)
            e_t = ds["e_target"].cpu().numpy()
            f_t = ds["f_target"].cpu().numpy()
            types = ds["types"].cpu().numpy()
            nat = ds["nat_host"]
            for i, g in enumerate(ds["groups"]):
                fn = ds["files"][i]
                tb = int(ds["test"][i])
                na = int(nat[i])
                if fhc:
                    fhc.write(f"{fn} {g} {na} {e_t[i]:.10e} "
                              f"{e_pred[i]:.10e} {tb}\n")
                if fha:
                    for k in range(na):
                        ft = f_t[i, k]
                        fp = f_pred[i, k]
                        fha.write(
                            f"{fn} {g} {k} {types[i, k] + 1} "
                            f"{ft[0]:.10e} {ft[1]:.10e} {ft[2]:.10e} "
                            f"{fp[0]:.10e} {fp[1]:.10e} {fp[2]:.10e} "
                            f"{tb}\n")
        if fhc:
            fhc.close()
        if fha:
            fha.close()

    def error_analysis(self, a=None, b=None, w=None, fs_dict=None):
        """Energy and force errors per (Group, Testing) and over all
        groups, as the JAX package's NN table."""
        if self.model is None or self.buckets is None:
            self.errors = []
            return
        if self.pas:
            return self._error_analysis_pas()
        extras = self.config.sections["EXTRAS"]
        if extras.dump_perconfig or extras.dump_peratom:
            self._dump_details()
        rows_e, rows_f = {}, {}
        for ds in self.buckets:
            e_pred, f_pred = self.evaluate_bucket(ds)
            e_t = ds["e_target"].cpu().numpy()
            f_t = ds["f_target"].cpu().numpy()
            realm = ds["real"].cpu().numpy()
            for i, g in enumerate(ds["groups"]):
                label = "Testing" if ds["test"][i] else "Training"
                rows_e.setdefault((g, label), []).append(
                    e_pred[i] - e_t[i])
                rows_f.setdefault((g, label), []).append(
                    (f_pred[i] - f_t[i])[realm[i]])
        index, values = [], []
        keys = sorted(rows_e) + [("*ALL", "Training"), ("*ALL", "Testing")]
        for g, label in keys:
            if g == "*ALL":
                e_res = np.concatenate(
                    [np.atleast_1d(v) for (gg, ll), vs in rows_e.items()
                     if ll == label for v in vs] or [np.zeros(0)])
                f_res = np.concatenate(
                    [v.reshape(-1) for (gg, ll), vs in rows_f.items()
                     if ll == label for v in vs] or [np.zeros(0)])
            else:
                e_res = np.array(rows_e[(g, label)])
                f_res = np.concatenate(
                    [v.reshape(-1) for v in rows_f[(g, label)]])
            if e_res.size == 0:
                continue
            index.append((g, label))
            values.append([
                e_res.size, np.abs(e_res).mean(),
                np.sqrt((e_res ** 2).mean()), f_res.size,
                np.abs(f_res).mean() if f_res.size else 0.0,
                np.sqrt((f_res ** 2).mean()) if f_res.size else 0.0])
        self.errors = ErrorTable(index, values, NN_INDEX_NAMES, NN_COLUMNS)

    def _error_analysis_pas(self):
        """The PAS error table (JAX `_error_analysis_pas`): ncount, mae and
        rmse of the real atoms' residuals per (Group, Testing) and over all
        groups; no per-config or per-atom dumps."""
        rows = {}
        for ds in self.buckets:
            pred, _ = self.evaluate_bucket(ds)
            t = ds["pas_target"].cpu().numpy()
            realm = ds["real"].cpu().numpy()
            for i, g in enumerate(ds["groups"]):
                label = "Testing" if ds["test"][i] else "Training"
                rows.setdefault((g, label), []).append(
                    (pred[i] - t[i])[realm[i]])
        index, values = [], []
        keys = sorted(rows) + [("*ALL", "Training"), ("*ALL", "Testing")]
        for g, label in keys:
            if g == "*ALL":
                res = np.concatenate(
                    [v for (gg, ll), vs in rows.items() if ll == label
                     for v in vs] or [np.zeros(0)])
            else:
                res = np.concatenate(rows[(g, label)])
            if res.size == 0:
                continue
            index.append((g, label))
            values.append([res.size, np.abs(res).mean(),
                           np.sqrt((res ** 2).mean())])
        self.errors = ErrorTable(index, values, NN_INDEX_NAMES, PAS_COLUMNS)
