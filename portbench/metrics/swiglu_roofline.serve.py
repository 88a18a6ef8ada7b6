"""B3 in serving: the least time of the traced stretch's calls (one a
layer a tick on every slot's row, one a layer an admission on its bucket's
rows; ``counts.swiglu_work``) over its kernels' device time, in percent."""

from portbench import counts, readers


def read(run):
    m = run["model"]
    size = readers.itemsize(m)

    def least(run, tr):
        rows = [tr["n_slots"]] * len(tr["live"]) + list(tr["buckets"])
        total = 0.0
        for r in rows:
            one = readers.least(run, *counts.swiglu_work(r, m["d_model"], m["d_ff"], size))
            if one is None:
                return None
            total += one * m["num_layers"]
        return total

    return readers.roofline(run, "swiglu", least)
