"""B3, the fused SwiGLU forward (and its recompute under ``save_attn``):
the least time of the traced steps' calls (``counts.swiglu_work`` on the
step's rows) over its kernels' device time, in percent."""

from portbench import counts, readers


def read(run):
    m, t = run["model"], run["traffic"]

    def least(run, tr):
        flops, nbytes = counts.swiglu_work(t["batch"] * t["seq"], m["d_model"], m["d_ff"],
                                           readers.itemsize(m))
        one = readers.least(run, flops, nbytes)
        return None if one is None else one * tr["calls"]["swiglu"]

    return readers.roofline(run, "swiglu", least)
