"""Post-fit error/plot utilities on the dumped dataframe (reference
`fitsnap3lib/tools/dataframe_tools.py`).

Operates on the pickled `FitSNAP.df` produced by EXTRAS dump_dataframe (or
a live DataFrame): columns `preds`, `truths`, `weights`, `Row_Type`,
`Groups`, `Testing` (plus the raw descriptor columns).

Copy of `fitsnap_tpu/tools/dataframe_tools.py`; pandas, matplotlib and
sklearn are imported where they are used, so the module imports without
them.
"""

import numpy as np


class DataframeTools:
    def __init__(self, dataframe):
        import pandas as pd

        if isinstance(dataframe, str):
            self.dataframe = dataframe
            self.df = None
        elif isinstance(dataframe, pd.DataFrame):
            self.df = dataframe
        else:
            raise ValueError("dataframe must be a pickle filename or a "
                             "pandas DataFrame")

    def read_dataframe(self):
        import pandas as pd

        self.df = pd.read_pickle(self.dataframe)
        return self.df

    def _frame(self):
        if self.df is None:
            self.read_dataframe()
        return self.df

    def _select(self, quantity, fitting_set, group_set):
        df = self._frame()
        test_bool = {"Training": False, "Testing": True}.get(fitting_set)
        if test_bool is None:
            raise ValueError("fitting_set must be Training or Testing")
        m = (df["Row_Type"] == quantity) & (df["Testing"] == test_bool)
        if group_set is not None:
            if isinstance(group_set, str):
                group_set = [group_set]
            m &= df["Groups"].isin(group_set)
        return df.loc[m]

    def natoms_per_config(self):
        """Atom counts recovered from the Energy/Force row pattern
        (reference dataframe_tools.py:90-105)."""
        row_type = self._frame()["Row_Type"].tolist()
        counts = []
        for rt in row_type:
            if rt == "Energy":
                counts.append(0)
            elif rt == "Force" and counts:
                counts[-1] += 1
        return (np.asarray(counts) // 3).astype(int)

    def _energy_natoms(self, sel):
        """Atom counts aligned with the Energy rows of a `_select` result.

        Energy rows are stored per-atom (reference dataframe_tools.py:164);
        `peratom=False` views need them scaled back up by natoms.
        """
        import pandas as pd

        df = self._frame()
        counts = self.natoms_per_config()
        e_index = df.index[df["Row_Type"] == "Energy"]
        by_row = pd.Series(counts, index=e_index)
        return by_row.loc[sel.index].to_numpy()

    def _values(self, quantity, fitting_set, group_set, peratom):
        sel = self._select(quantity, fitting_set, group_set)
        truths = np.asarray(sel["truths"], float)
        preds = np.asarray(sel["preds"], float)
        if quantity == "Energy" and not peratom and len(sel):
            natoms = self._energy_natoms(sel)
            if (natoms == 0).any():
                raise ValueError(
                    "peratom=False rescaling needs atom counts, which are "
                    "recovered from Force rows — this dataframe has none "
                    "(energy-only fit). Use peratom=True.")
            truths = truths * natoms
            preds = preds * natoms
        return sel, truths, preds

    def calc_error(self, quantity, fitting_set="Testing", group_set=None,
                   metric="mae", peratom=True):
        """MAE (or RMSE with metric='rmse') of `preds` vs `truths` for
        Energy (stored per-atom; peratom=False rescales to total energy)
        or Force rows."""
        _, truths, preds = self._values(quantity, fitting_set, group_set,
                                        peratom)
        res = preds - truths
        if res.size == 0:
            return float("nan")
        if metric == "rmse":
            return float(np.sqrt(np.mean(res ** 2)))
        return float(np.mean(np.abs(res)))

    def plot_agreement(self, quantity, fitting_set="Testing",
                       mode="Distribution", group_set=None, legend=True,
                       peratom=True, fname=None):
        """Truth-vs-prediction scatter (mode='Linear') or per-group residual
        histogram (mode='Distribution'); saves to `fname` when given.
        Parity with reference dataframe_tools.py:217 (group coloring,
        peratom energy scaling)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        sel, truths, preds = self._values(quantity, fitting_set, group_set,
                                          peratom)
        groups = np.asarray(sel["Groups"])
        uniq = sorted(set(groups))
        fig, ax = plt.subplots(figsize=(5, 4))
        if mode == "Linear":
            for g in uniq:
                gm = groups == g
                ax.scatter(truths[gm], preds[gm], s=4, label=g, alpha=0.6)
            lo = min(truths.min(), preds.min())
            hi = max(truths.max(), preds.max())
            ax.plot([lo, hi], [lo, hi], "k--", lw=0.8)
            ax.set_xlabel(f"target {quantity}")
            ax.set_ylabel(f"model {quantity}")
        elif mode == "Distribution":
            res = preds - truths
            bins = np.histogram_bin_edges(res, bins=60)
            for g in uniq:
                ax.hist(res[groups == g], bins=bins, alpha=0.6, label=g)
            ax.set_xlabel(f"{quantity} residual")
            ax.set_ylabel("count")
        else:
            raise ValueError("mode must be 'Linear' or 'Distribution'")
        if legend:
            ax.legend(fontsize=6)
        fig.tight_layout()
        if fname:
            fig.savefig(fname, dpi=150)
        plt.close(fig)
        return fig

    def plot_tsne(self, num_descriptors, point_size=0.05, fname=None,
                  perplexity=None):
        """2-D t-SNE embedding of the descriptor columns, colored by group
        (reference dataframe_tools.py:471)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.lines import Line2D
        from sklearn.manifold import TSNE

        df = self._frame()
        X = df.iloc[:, 0:num_descriptors].to_numpy(float)
        codes = df["Groups"].astype("category").cat.codes.to_numpy()
        names = list(df["Groups"].astype("category").cat.categories)
        kw = {}
        if perplexity is not None:
            kw["perplexity"] = perplexity
        emb = TSNE(**kw).fit_transform(X)
        cmap = plt.get_cmap("tab20")
        fig, ax = plt.subplots(constrained_layout=True)
        ax.scatter(emb[:, 0], emb[:, 1], c=cmap(codes % 20), s=point_size)
        handles = [Line2D([0], [0], marker="o", color=cmap(i % 20),
                          label=names[i], linestyle="", markersize=8)
                   for i in range(len(names))]
        ax.legend(handles=handles, loc="center left",
                  bbox_to_anchor=(1, 0.5), fontsize=6)
        if fname:
            fig.savefig(fname, dpi=150)
        plt.close(fig)
        return emb
