"""Screen/logging output surface.

Covers the reference's observability flags
(`fitsnap3lib/io/outputs/outputs.py:20-60`): ``--log FILE`` routes python
`logging` to a file, ``--screen2file FILE`` redirects screen prints,
``--screen/--nscreen/--pscreen`` pick the verbosity mode.  The reference's
nscreen/pscreen variants are per-node / per-process prints in its MPI
runtime; this framework is a single program, so both behave as ``--screen``.
``--lammpslog`` has no target here (no embedded LAMMPS) and warns loudly
instead of being silently ignored.
"""

import logging

_state = {"screen": True, "fp": None, "logger": None, "quiet": False}


def init_output(args):
    """Configure the screen/log surface from parsed CLI args.  Under a
    process group only rank 0 prints, logs and writes a screen file."""
    from fitsnap_tpu_torch.utils.torchsetup import writer

    if _state["fp"] is not None:
        _state["fp"].close()
        _state["fp"] = None
    _state["quiet"] = not writer()
    if _state["quiet"]:
        _state.update(screen=False, logger=None)
        return
    logger = logging.getLogger("fitsnap_tpu_torch")
    if getattr(args, "log", None):
        # attach a file handler directly: basicConfig is a no-op once any
        # root handler exists (e.g. under pytest)
        for h in list(logger.handlers):
            logger.removeHandler(h)
        logger.addHandler(logging.FileHandler(args.log))
        logger.setLevel(logging.DEBUG)
    _state["logger"] = logger
    s2f = getattr(args, "screen2file", None)
    if s2f:
        _state["fp"] = open(s2f, "a")
    _state["screen"] = bool(getattr(args, "screen", True)
                            or getattr(args, "nscreen", False)
                            or getattr(args, "pscreen", False))
    for flag in ("lammpslog", "printlammps", "lammps_noexceptions"):
        if getattr(args, flag, False):
            warn(f"--{flag}: fitsnap_tpu_torch has no embedded LAMMPS; "
                 "flag has no effect")


def screen(*args, **kw):
    """Print to the screen target (stdout or the --screen2file file)."""
    if _state["fp"] is not None:
        print(*args, file=_state["fp"], **kw)
        _state["fp"].flush()
    elif _state["screen"]:
        print(*args, **kw)
    if _state["logger"] is not None:
        _state["logger"].info(" ".join(str(a) for a in args))


def info(msg):
    if _state["quiet"]:
        return
    (_state["logger"] or logging.getLogger("fitsnap_tpu_torch")).info(msg)
    if _state["fp"] is not None:
        print(msg, file=_state["fp"])
        _state["fp"].flush()


def warn(msg):
    if _state["quiet"]:
        return
    (_state["logger"] or logging.getLogger("fitsnap_tpu_torch")).warning(msg)
    target = _state["fp"]
    print(f"WARNING: {msg}", **({"file": target} if target else {}))
