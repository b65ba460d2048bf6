"""Executable entry: `python -m fitsnap_tpu_torch input.in [--device cpu]`.

Mirrors the reference CLI: scrape -> process -> fit -> output.  The fit runs
on the CUDA device unless `--device cpu` is given.
"""

import sys


def main():
    from fitsnap_tpu_torch.fitsnap import FitSnap
    from fitsnap_tpu_torch.io.screen import screen
    from fitsnap_tpu_torch.utils.graceful import GracefulStop

    fs = FitSnap(arglist=sys.argv[1:])
    # SIGINT/SIGTERM stop the run at the next stage boundary; completed
    # stages still report their timings, and a finished fit is written out
    with GracefulStop(screen=screen) as stop:
        fs.scrape_configs(delete_scraper=True)
        if not stop:
            fs.process_configs(delete_data=False)
        skipped_fit = bool(stop)
        if not skipped_fit:
            fs.perform_fit()
            fs.write_output()
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
