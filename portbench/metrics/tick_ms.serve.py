"""Host time a decode tick: the window over the engine's tick counter's
advance in it (admissions between ticks included)."""


def read(run):
    return run["window_s"] / run["ticks"] * 1e3 if run["ticks"] else None
