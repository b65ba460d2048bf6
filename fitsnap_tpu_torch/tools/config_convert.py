"""Convert between FitSNAP INI input files and nested settings dicts.

Behavioral equivalent of the reference's `tools/input_to_settings_dict.py`
and `tools/settings_dict_to_input.py`: both directions round-trip through
the same section/key schema the `Config` system consumes, so library-mode
scripts and INI-driven runs stay interchangeable.

Copy of `fitsnap_tpu/tools/config_convert.py`.
"""

import configparser


def input_to_settings_dict(infile):
    """INI input file -> nested {SECTION: {key: value}} dict (strings)."""
    cp = configparser.ConfigParser(inline_comment_prefixes="#")
    cp.optionxform = str
    cp.read(infile)
    return {s: dict(cp.items(s)) for s in cp.sections()}


def settings_dict_to_input(settings, outfile=None):
    """Nested settings dict -> INI text (optionally written to a file)."""
    lines = []
    for section, kv in settings.items():
        lines.append(f"[{section}]")
        for k, v in kv.items():
            if isinstance(v, (list, tuple)):
                v = " ".join(str(x) for x in v)
            lines.append(f"{k} = {v}")
        lines.append("")
    text = "\n".join(lines)
    if outfile:
        with open(outfile, "w") as f:
            f.write(text)
    return text


if __name__ == "__main__":
    import json
    import sys

    if len(sys.argv) < 2:
        print(__doc__)
        sys.exit(1)
    print(json.dumps(input_to_settings_dict(sys.argv[1]), indent=2))
