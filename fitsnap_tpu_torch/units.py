"""Unit conversion registry.

Same semantics as the reference registry (`fitsnap3lib/units/`): each
dimension maps unit names to the factor that converts them to LAMMPS "metal"
units (eV, angstrom, eV/A, bar, g/mol, K, ps).  `convert(type, a, b)` returns
the factor taking values in unit `a` to unit `b`.

Unit names are normalized: '/' -> '_per_', '*' -> '_'.
"""

_ENERGY = {
    "metal": 1.0, "ev": 1.0, "electron_volt": 1.0, "electronvolt": 1.0,
    "atomic": 27.2114, "hartree": 27.2114, "ha": 27.2114, "eh": 27.2114,
    "ryd": 13.6056980659, "rydberg": 13.6056980659, "ry": 13.6056980659,
}

_FORCE = {
    "metal": 1.0, "electronvoltperangstrom": 1.0, "ev_per_angstrom": 1.0,
    "ev_per_ang": 1.0,
    "newtons": 6.424e8, "n": 6.424e8, "kg_m_per_s_per_s": 6.424e8,
    # NOTE: "dyne" vs "dynes" disagree in the 2nd digit — this transcribes
    # the reference's own inconsistency (fitsnap3lib/units/force.py:15-16,
    # 6.424e11 vs 6.242e11; the correct value is 6.2415e11 eV/Å per dyne)
    # so that fits using either spelling reproduce reference numbers.
    "dyne": 6.424e11, "dynes": 6.242e11,
    "atomic": 51.422, "hartree_per_bohr": 51.422, "ha_per_bohr": 51.422,
    "ha_per_au": 51.422,
}

_LENGTH = {
    "metal": 1.0, "angstrom": 1.0, "angstroms": 1.0, "ang": 1.0,
    "atomic": 0.52917721067121, "bohr": 0.52917721067121,
    "au": 0.52917721067121,
    "m": 1e-10, "meter": 1e-10, "meters": 1e-10,
    "cm": 1e-7, "centimeter": 1e-7, "centimeters": 1e-7,
}

_PRESSURE = {
    "metal": 1.0, "bars": 1.0, "bar": 1.0,
    "kbar": 1000.0, "kb": 1000.0,
    "atm": 1.01325, "atomic": 1e-5, "pa": 1e-5, "kpa": 0.01,
    "eh_per_bohr_per_bohr_per_bohr": 2.942102648438959e8,
}

_MASS = {
    "metal": 1.0, "grams_per_mol": 1.0, "gpm": 1.0, "amu": 1.0,
    "atomic": 1.0, "atomic_mass_unit": 1.0,
    "grams": 6.022e23, "gram": 6.022e23, "g": 6.022e23,
    "kg": 6.022e26, "kilograms": 6.022e26, "kilo": 6.022e26,
    "picogram": 6.022e11, "pico": 6.022e11, "pg": 6.022e11,
    "attogram": 6.022e5, "atto": 6.022e5, "ag": 6.022e5,
}

_TEMPERATURE = {"metal": 1.0, "kelvin": 1.0, "atomic": 1.0}

_TIME = {
    "metal": 1.0, "s": 1e-12, "second": 1e-12, "ms": 1e-9,
    "millisecond": 1e-9, "microsecond": 1e-6, "ns": 1e-3, "nanosecond": 1e-3,
    "ps": 1.0, "pico": 1.0, "picosecond": 1.0,
    "atomic": 1e3, "fs": 1e3, "femto": 1e3, "femtosecond": 1e3,
}

_TABLES = {
    "energy": _ENERGY,
    "force": _FORCE,
    "length": _LENGTH,
    "pressure": _PRESSURE,
    "mass": _MASS,
    "temperature": _TEMPERATURE,
    "time": _TIME,
}

_ALT_TYPE = {
    "stress": "pressure",
    "virial": "pressure",
    "positions": "length",
    "position": "length",
    "forces": "force",
    "lattice": "length",
}


def _norm_unit(name: str) -> str:
    return "_".join("_per_".join(str(name).split("/")).split("*")).lower()


_MEMO = {}


def convert(unit_type, unit_a=None, unit_b=None) -> float:
    """Factor converting values in `unit_a` to `unit_b` for a dimension.

    Accepts either three args or a single [type, a, b] list (the reference
    calling convention, `units/units.py:6`).  Memoized: scrapers call this
    per file with a handful of distinct specs.
    """
    if isinstance(unit_type, (list, tuple)):
        unit_type, unit_a, unit_b = unit_type
    key = (unit_type, unit_a, unit_b)
    hit = _MEMO.get(key)
    if hit is not None:
        return hit
    t = str(unit_type).lower()
    t = _ALT_TYPE.get(t, t)
    table = _TABLES.get(t)
    if table is None:
        raise KeyError(f"unknown unit dimension: {unit_type}")
    try:
        num = table[_norm_unit(unit_a)]
        den = table[_norm_unit(unit_b)]
    except KeyError as e:
        raise KeyError(f"unknown {t} unit: {e}") from None
    _MEMO[key] = num / den
    return _MEMO[key]
