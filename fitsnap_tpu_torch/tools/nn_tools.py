"""NN output analysis on the per-atom / per-config dump files (reference
`fitsnap3lib/tools/nn_tools.py`).

Files come from EXTRAS `dump_peratom` / `dump_perconfig` during NN error
analysis: space-delimited with headers
  perconfig: Filename Group Natoms Energy_Truth Energy_Pred Testing_Bool
  peratom:   Filename Group AtomID Type F{x,y,z}_Truth F{x,y,z}_Pred
             Testing_Bool

Copy of `fitsnap_tpu/tools/nn_tools.py`; pandas and matplotlib are
imported where they are used, so the module imports without them.
"""

import numpy as np


class NNTools:
    def __init__(self, peratom_file=None, perconfig_file=None):
        import pandas as pd

        self.dfa = pd.read_csv(peratom_file, sep=r"\s+") \
            if peratom_file else None
        self.dfc = pd.read_csv(perconfig_file, sep=r"\s+") \
            if perconfig_file else None

    def calc_errors(self, quantity):
        """{'train'|'test'}{'mae'|'rmse'} for 'Energy' or 'Force'."""
        if quantity == "Energy":
            df = self.dfc
            truth_cols, pred_cols = ["Energy_Truth"], ["Energy_Pred"]
        elif quantity == "Force":
            df = self.dfa
            truth_cols = ["Fx_Truth", "Fy_Truth", "Fz_Truth"]
            pred_cols = ["Fx_Pred", "Fy_Pred", "Fz_Pred"]
        else:
            raise ValueError("quantity must be 'Energy' or 'Force'")
        if df is None:
            raise ValueError(f"no dump file loaded for {quantity}")
        ret = {"train": {}, "test": {}}
        test = df["Testing_Bool"].astype(bool)
        for name, m in (("train", ~test), ("test", test)):
            t = np.concatenate([df.loc[m, c].to_numpy() for c in truth_cols])
            p = np.concatenate([df.loc[m, c].to_numpy() for c in pred_cols])
            if t.size == 0:
                ret[name]["mae"] = ret[name]["rmse"] = float("nan")
                continue
            ret[name]["mae"] = float(np.mean(np.abs(t - p)))
            ret[name]["rmse"] = float(np.sqrt(np.mean((t - p) ** 2)))
        return ret

    def plot_comparisons(self, quantity, mode="Linear", fname=None):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        if quantity == "Energy":
            df, tc, pc = self.dfc, "Energy_Truth", "Energy_Pred"
            t = df[tc].to_numpy()
            p = df[pc].to_numpy()
        else:
            df = self.dfa
            t = np.concatenate([df[c].to_numpy()
                                for c in ("Fx_Truth", "Fy_Truth",
                                          "Fz_Truth")])
            p = np.concatenate([df[c].to_numpy()
                                for c in ("Fx_Pred", "Fy_Pred", "Fz_Pred")])
        fig, ax = plt.subplots(figsize=(5, 4))
        if mode == "Linear":
            ax.scatter(t, p, s=3)
            lo, hi = min(t.min(), p.min()), max(t.max(), p.max())
            ax.plot([lo, hi], [lo, hi], "k--", lw=0.8)
            ax.set_xlabel(f"target {quantity}")
            ax.set_ylabel(f"model {quantity}")
        else:
            ax.hist(p - t, bins=60)
            ax.set_xlabel(f"{quantity} residual")
        fig.tight_layout()
        if fname:
            fig.savefig(fname, dpi=150)
        plt.close(fig)
        return fig
