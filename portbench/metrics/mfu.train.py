"""The whole step's share of the cards' peak: model FLOPs of the window's
steps (the architecture's ``train_step_flops``, every rank's rows) over the
window and the chips' dense bf16 peak, in percent."""

from portbench import readers, spec


def read(run):
    peak = readers.peak_flops(run)
    r0, t = run["ranks"][0], run["traffic"]
    if peak is None or not r0["steps"]:
        return None
    flops = spec.architecture(run["conf"]).train_step_flops(
        run["model"], t["batch"] * t.get("world", 1), t["seq"])
    return 100.0 * flops * r0["steps"] / r0["window_s"] / (run["chips"] * peak)
