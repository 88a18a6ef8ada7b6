"""The served work's share of the card's peak: the architecture's
``prefill_flops`` of each first token the engine emitted in the window (its
prompt) plus its ``decode_tick_flops`` of each later token (one row reading
its prompt and the tokens before it), over the window and the dense bf16
peak, in percent."""

from portbench import readers, spec


def read(run):
    peak = readers.peak_flops(run)
    if peak is None:
        return None
    m, arch = run["model"], spec.architecture(run["conf"])
    flops = sum(arch.prefill_flops(m, plen) if k == 0
                else arch.decode_tick_flops(m, 1, plen + k)
                for _, plen, k, _ in run["emitted"])
    return 100.0 * flops / (run["t1"] - run["t0"]) / peak if flops else None
