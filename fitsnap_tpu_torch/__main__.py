"""Executable entry: `python -m fitsnap_tpu_torch input.in [--device cpu]`.

Mirrors the reference CLI: scrape -> process -> fit -> output.  The fit runs
on the CUDA device unless `--device cpu` is given.  `--torchprof DIR`
writes a torch.profiler Chrome trace of the run into DIR.
"""

import os
import sys


def start_profiler(device):
    """A started torch.profiler session: CPU activity, and CUDA activity
    when the run is on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_profiler(prof, prof_dir):
    """Stop the session and write its Chrome trace into `prof_dir`;
    returns the trace's path."""
    prof.stop()
    os.makedirs(prof_dir, exist_ok=True)
    path = os.path.join(prof_dir,
                        f"fitsnap_tpu_torch_{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


def main():
    from fitsnap_tpu_torch.fitsnap import FitSnap
    from fitsnap_tpu_torch.io.screen import screen
    from fitsnap_tpu_torch.utils.graceful import GracefulStop

    fs = FitSnap(arglist=sys.argv[1:])
    prof_dir = fs.config.args.torchprof
    prof = start_profiler(fs.device) if prof_dir else None
    # SIGINT/SIGTERM stop the run at the next stage boundary; completed
    # stages still report their timings, and a finished fit is written out
    try:
        with GracefulStop(screen=screen) as stop:
            fs.scrape_configs(delete_scraper=True)
            if not stop:
                fs.process_configs(delete_data=False)
            skipped_fit = bool(stop)
            if not skipped_fit:
                fs.perform_fit()
                fs.write_output()
    finally:
        # the trace is written also when the run raises
        if prof is not None:
            screen(f"profiler trace written to "
                   f"{stop_profiler(prof, prof_dir)}")
    if skipped_fit:
        screen("stopped on signal before fitting; no outputs were written")
    elif stop:
        screen("caught signal during fitting; the fit completed and "
               "outputs were written")
    for stage, dt in fs.timings.items():
        screen(f"{stage:>8}: {dt:8.3f} s")
    if stop:
        sys.exit(1)


if __name__ == "__main__":
    main()
