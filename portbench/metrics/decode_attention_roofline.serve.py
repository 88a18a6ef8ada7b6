"""B1, flash-decoding over the dense cache: the least time of the traced
ticks' calls (``counts.decode_attention_work``: q and the output of every
slot's row, and the K and V rows up to each live slot's position) over its
kernels' device time, in percent."""

from portbench import counts, readers


def read(run):
    m = run["model"]
    heads = m["num_heads"]
    kv = m.get("num_kv_heads") or heads

    def least(run, tr):
        total = 0.0
        for live in tr["live"]:
            visible = sum(p + 1 for p in live)
            one = readers.least(run, *counts.decode_attention_work(
                tr["n_slots"], heads, kv, m["d_model"] // heads, visible, readers.itemsize(m)))
            if one is None:
                return None
            total += one * m["num_layers"]
        return total

    return readers.roofline(run, "decode_attention", least)
