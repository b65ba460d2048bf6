"""Group-table helpers for library mode (reference
`fitsnap3lib/tools/group_tools.py`).

Copy of `fitsnap_tpu/tools/group_tools.py`."""

import math
import random


def make_table(group_settings):
    """Group-table dict from a settings dict whose "group_sections" key
    names the columns and whose other keys are per-group value lists."""
    group_settings = dict(group_settings)
    group_sections = group_settings.pop("group_sections")
    return {k: {group_sections[i]: item for i, item in enumerate(v)}
            for k, v in group_settings.items()}


def assign_validation(group_table, random_test=False):
    """Add per-config "test_bools" to each group (keys "nconfigs" and
    "testing_size" required); random or tail split."""
    for name in group_table:
        nconfigs = group_table[name]["nconfigs"]
        assert "testing_size" in group_table[name]
        assert group_table[name]["testing_size"] <= 1.0
        if random_test:
            group_table[name]["test_bools"] = [
                random.random() < group_table[name]["testing_size"]
                for _ in range(nconfigs)]
        else:
            ntest = math.ceil(group_table[name]["testing_size"] * nconfigs)
            ntrain = nconfigs - ntest
            group_table[name]["test_bools"] = [
                i > ntrain for i in range(nconfigs)]
