"""Solver base: weight application, error analysis, coefficient reshaping.

Counterpart of `fitsnap_tpu/solvers/solver.py`.  The grouped error table
(ncount/mae/rmse/rsq, unweighted and weighted, `*ALL` plus per group) has
the same index structure, Group / Weighting / Testing / Subsystem, and the
same numbers; it is computed with numpy and kept in a small `ErrorTable`
instead of a pandas DataFrame.  pandas is imported only where a DataFrame
is asked for: `dump_dataframe` and the DF metric style.
"""

import json

import numpy as np

_COLUMNS = ("ncount", "mae", "rmse", "rsq")
_INDEX_NAMES = ("Group", "Weighting", "Testing", "Subsystem")
NN_COLUMNS = ("ncount_E", "mae_E", "rmse_E", "ncount_F", "mae_F", "rmse_F")
NN_INDEX_NAMES = ("Group", "Testing")
PAS_COLUMNS = ("ncount", "mae", "rmse")


class ErrorTable:
    """Grouped fit errors.

    `index` is a list of tuples of `index_names` and `values` an (n,
    len(columns)) array, row by row in the order of the JAX package's
    table.  The linear table's index is (Group, Weighting, Testing,
    Subsystem) and its columns ncount, mae, rmse, rsq; the NN solver's are
    NN_INDEX_NAMES and NN_COLUMNS (PAS: PAS_COLUMNS).  Columns named
    ncount* are counts.
    """

    def __init__(self, index, values, index_names=_INDEX_NAMES,
                 columns=_COLUMNS):
        self.index = list(index)
        self.index_names = tuple(index_names)
        self.columns = tuple(columns)
        self.values = np.asarray(values, np.float64).reshape(
            -1, len(self.columns))

    def __len__(self):
        return len(self.index)

    def _cells(self, v, fmt):
        return [str(int(x)) if c.startswith("ncount") else fmt.format(x)
                for c, x in zip(self.columns, v)]

    def to_markdown(self):
        head = "| " + " | ".join(self.index_names + self.columns) + " |"
        rule = "|" + "|".join([":---"] * len(self.index_names)
                              + ["---:"] * len(self.columns)) + "|"
        lines = [head, rule]
        for key, v in zip(self.index, self.values):
            lines.append("| " + " | ".join(
                list(key) + self._cells(v, "{:.8g}")) + " |")
        return "\n".join(lines) + "\n"

    def to_csv(self, sep=","):
        lines = [sep.join(self.index_names + self.columns)]
        for key, v in zip(self.index, self.values):
            lines.append(sep.join(list(key) + self._cells(v, "{:.8f}")))
        return "\n".join(lines) + "\n"

    def to_json(self):
        """The text of pandas' `DataFrame.to_json()` of the JAX package's
        table: {column: {str(index tuple): value}}, counts as integers,
        other values as pandas writes them (`_json_double`), NaN and
        infinities as null."""
        keys = [_json_string(str(tuple(k))) for k in self.index]
        cols = []
        for j, c in enumerate(self.columns):
            cells = (str(int(x)) if c.startswith("ncount") else
                     _json_double(x) for x in self.values[:, j])
            cols.append(_json_string(c) + ":{" + ",".join(
                f"{k}:{v}" for k, v in zip(keys, cells)) + "}")
        return "{" + ",".join(cols) + "}"

    def to_dataframe(self):
        """The JAX package's pandas DataFrame of this table."""
        import pandas as pd

        index = pd.MultiIndex.from_tuples(self.index, names=self.index_names)
        return pd.DataFrame(
            {c: (self.values[:, j].astype(np.int64) if c.startswith("ncount")
                 else self.values[:, j])
             for j, c in enumerate(self.columns)}, index=index)


def _json_string(s):
    """A JSON string as pandas' encoder writes it (ASCII, '/' escaped)."""
    return json.dumps(s).replace("/", "\\/")


def _json_double(x, precision=10):
    """A float as pandas' `to_json` writes it at its default
    `double_precision` of 10: NaN and infinities as null, magnitudes above
    1e16 - 1 or below 1e-15 in printf's %.10g, the rest in fixed point
    rounded to 10 decimals (half to odd, or up from a zero fraction) with
    trailing zeros dropped."""
    x = float(x)
    if x != x or x in (float("inf"), float("-inf")):
        return "null"
    neg = x < 0
    value = -x if neg else x
    if value > 1e16 - 1 or (value != 0.0 and value < 1e-15):
        return f"{x:.{precision}g}"
    pow10 = 10 ** precision
    whole = int(value)
    tmp = (value - whole) * float(pow10)
    frac = int(tmp)
    diff = tmp - frac
    if diff > 0.5 or (diff == 0.5 and (frac == 0 or frac & 1)):
        frac += 1
    if frac >= pow10:
        frac = 0
        whole += 1
    if frac:
        digits = str(frac).rjust(precision, "0").rstrip("0")
    else:
        digits = "0"
    return ("-" if neg else "") + f"{whole}.{digits}"


def _group_errors(truths, preds, weights):
    """(unweighted, weighted) [ncount, mae, rmse, rsq] of one row group."""
    res = truths - preds
    mae = np.mean(abs(res))
    ssr = np.square(res).sum()
    n = len(truths)
    rmse = np.sqrt(ssr / n)
    rsq = 1 - ssr / np.sum(np.square(truths - (truths / n).sum()))
    w_res = weights * res
    w_mae = np.mean(abs(w_res))
    w_ssr = np.square(w_res).sum()
    w_n = np.count_nonzero(weights)
    w_rmse = np.sqrt(w_ssr / w_n) if w_n else 0.0
    wt = weights * truths
    w_rsq = 1 - w_ssr / np.sum(np.square(wt - (wt / w_n).sum())) \
        if w_n else 0.0
    return [n, mae, rmse, rsq], [w_n, w_mae, w_rmse, w_rsq]


def error_table(truths, preds, weights, groups, testing, row_types):
    """Grouped error table over the rows of a fit.

    Rows are grouped by (Testing, Row_Type) for `*ALL` and by (Group,
    Testing, Row_Type) per group; the table lists `*ALL` first, then the
    groups, each sorted by (Weighting, Testing, Subsystem) with Training
    before Testing.
    """
    groups = np.asarray(groups, object)
    testing = np.asarray(testing, bool)
    row_types = np.asarray(row_types, object)
    index, values = [], []

    def add(group, sel_rows):
        keys = sorted({(bool(t), str(r)) for t, r in
                       zip(testing[sel_rows], row_types[sel_rows])})
        stats = {}
        for t, r in keys:
            sel = sel_rows & (testing == t) & (row_types == r)
            stats[(t, r)] = _group_errors(truths[sel], preds[sel],
                                          weights[sel])
        for wi, wname in enumerate(("Unweighted", "weighted")):
            for t, r in keys:
                index.append((group, wname, "Testing" if t else "Training",
                              r))
                values.append(stats[(t, r)][wi])

    everything = np.ones(len(truths), bool)
    add("*ALL", everything)
    for g in sorted(set(groups.tolist())):
        add(str(g), groups == g)
    return ErrorTable(index, values)


class Solver:
    def __init__(self, name, config, linear=True):
        self.config = config
        self.name = name
        self.fit = None
        self.fit_sam = None
        self.cov = None
        self.errors = []
        self.df = None
        self.linear = linear

    def perform_fit(self, a, b, w, fs_dict):
        raise NotImplementedError

    @staticmethod
    def prepare_data(a, b, w, fs_dict):
        """Apply weights and the training mask."""
        if fs_dict is not None:
            training = np.array([not t for t in fs_dict["Testing"]])
        else:
            training = np.ones(a.shape[0], bool)
        wt = w[training]
        return wt[:, None] * a[training], wt * b[training]

    def _offset(self):
        """Insert the zero constant-offset coefficient per type when
        bzeroflag=1 (reference `solver.py:78`)."""
        num_types = self.config.sections["BISPECTRUM"].numtypes
        ncoeff = self.config.sections["BISPECTRUM"].ncoeff
        fit = self.fit.reshape(num_types, ncoeff)
        fit = np.concatenate([np.zeros((num_types, 1)), fit], axis=1)
        self.fit = fit.reshape(-1)
        if self.fit_sam is not None:
            nsam = self.fit_sam.shape[0]
            fs = self.fit_sam.reshape(nsam, num_types, ncoeff)
            fs = np.concatenate([np.zeros((nsam, num_types, 1)), fs], axis=2)
            self.fit_sam = fs.reshape(nsam, -1)

    def dump_dataframe(self, a, b, w, fs_dict):
        """Pickle the JAX package's per-row DataFrame (A's columns,
        truths, preds when fitted, weights and fs_dict's per-row lists) to
        OUTFILE's dataframe_file; it stays in `self.df`."""
        from pandas import DataFrame

        self.df = DataFrame(a)
        self.df["truths"] = b.tolist()
        if self.fit is not None:
            self.df["preds"] = a @ self.fit
        self.df["weights"] = w.tolist()
        for key, val in fs_dict.items():
            if isinstance(val, list) and len(val) == len(self.df.index):
                self.df[key] = val
        self.df.to_pickle(self.config.sections["OUTFILE"].dataframe_file)

    def error_analysis(self, a, b, w, fs_dict):
        self.errors = []
        if self.config.sections["EXTRAS"].dump_dataframe:
            self.dump_dataframe(a, b, w, fs_dict)
        if self.fit is None:
            return
        self.errors = error_table(
            np.asarray(b), a @ self.fit, np.asarray(w), fs_dict["Groups"],
            fs_dict["Testing"], fs_dict["Row_Type"])
        if (self.config.sections["CALCULATOR"].calculator == "LAMMPSSNAP"
                and self.config.sections["BISPECTRUM"].bzeroflag):
            self._offset()
