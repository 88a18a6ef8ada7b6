"""B5, the causal RoPE flash forward: the least time of the traced steps'
calls (``counts.flash_attention_rope_work`` at the step's batch, heads,
sequence and head size) over its kernels' device time, in percent."""

from portbench import counts, readers


def read(run):
    m, t = run["model"], run["traffic"]

    def least(run, tr):
        flops, nbytes = counts.flash_attention_rope_work(
            t["batch"], m["num_heads"], t["seq"], m["d_model"] // m["num_heads"],
            readers.itemsize(m))
        one = readers.least(run, flops, nbytes)
        return None if one is None else one * tr["calls"]["flash_attention_rope"]

    return readers.roofline(run, "flash_attention_rope", least)
