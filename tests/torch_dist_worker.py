"""A gloo world of spawned processes for the port's data-parallel tests.

`World(size, tmpdir)` starts `size` processes with the `spawn` method; each
joins a gloo group through a `file://` store under `tmpdir` (no network)
and then runs the tasks it is sent, each rank the same task, until the
world is closed.  `World.run(name, **kwargs)` returns the ranks' results in
rank order, or raises with the failing rank's traceback.  The tasks are
this module's functions named in `TASKS`; they import torch and
fitsnap_tpu_torch only, never jax, and take and return numpy arrays.
This module is not a test file: pytest collects nothing from it.
"""

import datetime
import multiprocessing
import os
import traceback
from contextlib import contextmanager

import numpy as np

TIMEOUT = 120.0     # seconds a collective, and a task, may take


class World:
    def __init__(self, size, tmpdir):
        ctx = multiprocessing.get_context("spawn")
        self.size = size
        self.tasks = [ctx.Queue() for _ in range(size)]
        self.results = ctx.Queue()
        os.makedirs(str(tmpdir), exist_ok=True)
        store = os.path.join(str(tmpdir), f"store{size}")
        self.procs = [ctx.Process(target=serve, daemon=True, args=(
            rank, size, store, self.tasks[rank], self.results))
            for rank in range(size)]
        for p in self.procs:
            p.start()

    def run(self, name, **kwargs):
        for q in self.tasks:
            q.put((name, kwargs))
        out = {}
        for _ in range(self.size):
            rank, ok, value = self.results.get(timeout=TIMEOUT)
            if not ok:
                raise RuntimeError(f"rank {rank} of {self.size}:\n{value}")
            out[rank] = value
        return [out[r] for r in range(self.size)]

    def close(self):
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(30)
            if p.is_alive():
                p.terminate()


def serve(rank, size, store, tasks, results):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(2)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=size,
        timeout=datetime.timedelta(seconds=TIMEOUT))
    try:
        while True:
            item = tasks.get()
            if item is None:
                break
            name, kwargs = item
            try:
                results.put((rank, True, TASKS[name](**kwargs)))
            except Exception:
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


@contextmanager
def inside(path):
    """Run in `path` (this rank's own directory under it, where there is
    a group), then return."""
    import torch.distributed as dist

    if dist.is_initialized():
        path = os.path.join(str(path), f"rank{dist.get_rank()}")
    os.makedirs(path, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(path)
    try:
        yield path
    finally:
        os.chdir(cwd)


def stream_batches(settings, n_pad, chunks):
    """The port's FitSnap, its one planned group and that group's
    positions batch and host-list batch (deterministic: every process and
    the test make the same ones)."""
    from fitsnap_tpu_torch import FitSnap
    from fitsnap_tpu_torch.ops import neighbors
    from fitsnap_tpu_torch.parallel import fit

    fs = FitSnap(settings, arglist=["--overwrite"], device="cpu")
    fs.scrape_configs()
    calc = fs.calculator
    packed = [calc._pack(d) for d in fs.data]
    g, = fit.plan_pos_buckets(packed, calc.cutoff, max_programs=1)
    pos = fit.pack_batch_pos(g["configs"], g["a_pad"], n_pad, g["s_table"],
                             np.float64, chunks=chunks)
    for pc in g["configs"]:
        pc.disp, pc.jidx, pc.mask, pc.kcount = neighbors.host_neighbors(
            pc.pos, pc.cell, pc.natoms, calc.cutoff)
    lists = fit.pack_batch(g["configs"], g["a_pad"], g["k_pad"], n_pad,
                           np.float64, chunks=chunks)
    nb = {"cutoff": calc.cutoff, "k_pad": g["k_pad"]}
    return calc, pos, lists, nb


def stream_results(settings, n_pad, chunks, x, flags):
    """Every streamed function of the port on the batches of
    `stream_batches`, the residual and the evaluation at `x`."""
    from fitsnap_tpu_torch.parallel import fit

    calc, pos, lists, nb = stream_batches(settings, n_pad, chunks)
    args = (calc.params, 1, flags)
    kw = dict(device="cpu", refspec=calc.refspec)
    step = fit.build_step_fn(*args, neighbors=nb, **kw)
    res = fit.build_residual_fn(*args, neighbors=nb, **kw)
    acc_step, init, finish = fit.build_step_fn(*args, neighbors=nb,
                                               accumulate=True, **kw)
    acc = acc_step(init(), pos)
    x_fit, _, n_fit = fit.fit_refined(step, res, pos)
    return {"step": step(pos),
            "acc": finish(acc_step(acc, fit.put_batch(pos, "cpu"))),
            "lists": fit.build_step_fn(*args, **kw)(lists),
            "res": res(x, pos),
            "eval": fit.build_eval_fn(*args, neighbors=nb, **kw)(x, pos),
            "fit": (x_fit, n_fit)}


def spatial_rows(settings, kind, arrays, flags):
    """`build_spatial_rows_fn` of the port on one config's arrays."""
    from fitsnap_tpu_torch import FitSnap
    from fitsnap_tpu_torch.parallel import fit

    calc = FitSnap(settings, arglist=["--overwrite"], device="cpu").calculator
    if kind == "snap":
        rows = fit.build_spatial_rows_fn(calc.params, calc.numtypes, flags,
                                         device="cpu")
    else:
        rows = fit.build_spatial_rows_fn(
            None, calc.numtypes, flags, device="cpu",
            kernel=fit.ace_kernel(calc.plan),
            const_mode=("ace", calc.numtypes))
    return rows(*arrays)


def tpu_svd(a, b, w, fs_dict):
    from fitsnap_tpu_torch.solvers.tpu_svd import TpuSVD

    return TpuSVD("TPUSVD", None, device="cpu").perform_fit(a, b, w, fs_dict)


def nn_fit(settings, root, init=None, devices=None):
    """A whole NN fit through the port's FitSnap (from the parameters
    `init` where given, else the port's seeded draw) in this rank's
    directory under `root`; returns the loss curve, the best parameters
    and the files this rank wrote."""
    import pytest

    from fitsnap_tpu_torch import FitSnap
    from fitsnap_tpu_torch.convert import mlp_params_from_numpy
    from fitsnap_tpu_torch.models.mlp import params_to_numpy
    from fitsnap_tpu_torch.solvers import network as tnet

    args = ["--overwrite"] + (["--devices", str(devices)] if devices else [])
    with inside(root), pytest.MonkeyPatch.context() as mp:
        if init is not None:
            mp.setattr(tnet, "init_mlp",
                       lambda *a, **k: mlp_params_from_numpy(init))
        fs = FitSnap(settings, arglist=args, device="cpu")
        fs.scrape_configs()
        fs.process_configs()
        fs.perform_fit()
        fs.write_output()
        return {"history": np.array(fs.solver.history),
                "params": params_to_numpy(fs.solver.model.params),
                "files": sorted(os.listdir("."))}


def scrape(settings, root):
    """The port's FitSnap scrape of `settings` in `root`, the same
    directory for every rank: the scraped dicts and the files under
    `root` afterwards."""
    from fitsnap_tpu_torch import FitSnap

    os.makedirs(root, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        data = FitSnap(settings, arglist=["--overwrite"],
                       device="cpu").scrape_configs()
    finally:
        os.chdir(cwd)
    files = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, fs in os.walk(root) for f in fs)
    return {"data": data, "files": files}


def nn_refused(settings, batch_size):
    """The message of the NN fit's refusal of batch_size < devices."""
    from fitsnap_tpu_torch import FitSnap

    settings = {k: dict(v) for k, v in settings.items()}
    settings["PYTORCH"]["batch_size"] = batch_size
    fs = FitSnap(settings, arglist=["--overwrite"], device="cpu")
    fs.scrape_configs()
    fs.process_configs()
    try:
        fs.perform_fit()
    except ValueError as e:
        return str(e)
    return None


TASKS = {f.__name__: f for f in (stream_results, spatial_rows, tpu_svd,
                                  nn_fit, nn_refused, scrape)}
