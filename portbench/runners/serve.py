"""Serving cells: the program's ``ServingEngine`` under a closed loop of
clients.

Traffic parameters (``traffic/<mix>.json``, ``"kind": "serve"``):
``slots`` and ``max_queue`` of the engine, ``clients`` (each sends its next
request when its previous one has streamed its last token), ``prompt`` and
``output`` lengths (``median``, ``sigma`` of a lognormal, clipped to
``min``..``max``), ``greedy_every`` (every n-th request is greedy, the
others sample at ``temperature`` and ``top_p``), ``warm_s`` (seconds the
loop runs in set-up before the window opens), ``trace_ticks`` (ticks in the
traced stretch), ``check_requests`` (greedy requests the reference
checks) and ``source`` (where the lengths come from; read by no code).

The tokens a window served are counted, and the gaps between a request's
tokens taken, from the engine itself (``TokenLog``): every token the engine
emits in the window, on the worker's clock as its tick or admission
returned.  The clients' own clock gives each request's time to its first
token.

Every seed gets the same multiset of request sizes: ``pool`` pairs of prompt
and output length are taken at fixed quantiles of the two distributions and
only their order, the prompts' tokens and the sampling seeds come from
``--seed``; the order is stratified (every ``strata`` consecutive requests
hold one of each stratum of output length), so that every stretch of the
loop serves the same mix.  Each client's first request is cut to a seeded share of its
output length, so that the pool's requests are of all ages when the window
opens.
"""

from __future__ import annotations

import math
import statistics
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from portbench import devices, spec, trace, weights
from portbench.reference import compare
from portbench.reference import model as reference
from portbench.runners import model_config


def request_sizes(traffic: dict) -> list[tuple[int, int]]:
    """``pool`` (prompt, output) length pairs at fixed quantiles of the two
    lognormals, paired by a fixed permutation (the same for every seed)."""
    n = traffic["pool"]
    z = np.array([statistics.NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])

    def lengths(d):
        v = np.round(d["median"] * np.exp(d["sigma"] * z)).astype(int)
        return np.clip(v, d["min"], d["max"])

    prompts = lengths(traffic["prompt"])
    outputs = lengths(traffic["output"])[np.random.default_rng(0).permutation(n)]
    return list(zip(prompts.tolist(), outputs.tolist()))


@dataclass
class Record:
    """One request as its client saw it: submitted at ``t_submit``, its
    first token streamed at ``t_first`` and its last at ``t_last`` (the
    clients' clock)."""

    index: int
    prompt: list
    max_new: int
    greedy: bool
    t_submit: float
    t_first: float | None = None
    t_last: float | None = None
    tokens: list = field(default_factory=list)
    result: object = None


class TokenLog:
    """Wraps the engine's ``tick`` and ``admit`` (instance attributes, so
    the serving loop calls these) and keeps what each returned, stamped on
    the worker's clock as it returned: every token the engine hands to the
    streams, as it leaves the engine.  The worker pays one clock read and
    one append a call."""

    def __init__(self, engine):
        self.log: list[tuple[float, list, int]] = []  # (t, events, prompt length or 0)
        tick, admit = engine.tick, engine.admit

        def logged_tick():
            events = tick()
            self.log.append((time.perf_counter(), events, 0))
            return events

        def logged_admit(prompt_ids, **knobs):
            event = admit(prompt_ids, **knobs)
            self.log.append((time.perf_counter(), [event], len(prompt_ids)))
            return event

        engine.tick, engine.admit = logged_tick, logged_admit

    def tokens(self) -> list[tuple[float, int, int, float | None]]:
        """``(t, prompt length, k, gap)`` of every token emitted, in order:
        the request's ``k``-th token (0: the one its prefill sampled) and
        the time since its previous token (None for the first)."""
        live: dict[int, list] = {}  # slot -> [t of its last token, prompt length, k]
        out = []
        for t, events, plen in self.log:
            for e in events:
                if plen:
                    state = live[e.slot] = [t, plen, 0]
                    out.append((t, plen, 0, None))
                else:
                    state = live[e.slot]
                    state[2] += 1
                    out.append((t, state[1], state[2], t - state[0]))
                    state[0] = t
                if e.finished:
                    del live[e.slot]
        return out


class Traffic:
    """The seeded sequence of requests, handed out to the clients in turn."""

    def __init__(self, traffic: dict, seed: int, vocab: int):
        self.t = traffic
        self.vocab = vocab
        self.sizes = request_sizes(traffic)
        self.rng = np.random.default_rng([int(seed), 3])
        self.order = self._stratified(traffic["strata"])
        self.next = 0
        self.lock = threading.Lock()

    def _stratified(self, k: int) -> list[int]:
        """A seeded order of the pool in which every ``k`` consecutive
        requests hold one of each of ``k`` strata of output length: any
        stretch of the loop sees the same mix, whatever the seed."""
        n = len(self.sizes)
        ranked = sorted(range(n), key=lambda i: (self.sizes[i][1], self.sizes[i][0], i))
        strata = [ranked[j * n // k:(j + 1) * n // k] for j in range(k)]
        for s in strata:
            self.rng.shuffle(s)
        order = []
        for b in range(n // k):
            block = [s[b] for s in strata]
            self.rng.shuffle(block)
            order += block
        return order

    def draw(self, cut: float | None = None):
        from bpe_transformer_tpu_torch.serving.server import Request

        with self.lock:
            i = self.next
            self.next += 1
            plen, out = self.sizes[self.order[i % len(self.order)]]
            prompt = self.rng.integers(0, self.vocab, plen).tolist()
            sample_seed = int(self.rng.integers(0, 2**31))
        if cut is not None:
            out = max(1, math.ceil(out * cut))
        greedy = i % self.t["greedy_every"] == 0
        knobs = {"temperature": 0.0} if greedy else {
            "temperature": self.t["temperature"], "top_p": self.t["top_p"], "seed": sample_seed}
        return Record(i, prompt, out, greedy, 0.0), Request(
            prompt_ids=tuple(prompt), max_new_tokens=out, **knobs)


class StretchTracer:
    """Wraps the engine's ``tick`` and ``admit`` (instance attributes, so
    the serving loop calls these).  When armed, the worker thread profiles
    ``n_ticks`` whole ticks and the admissions between them, recording each
    tick's live positions and each admission's bucket, with the device's
    activities alone (the metrics read this stretch); then as many ticks
    with every host operator too, which only names the idle gaps."""

    def __init__(self, engine, n_ticks: int, device):
        self.engine, self.n, self.device = engine, n_ticks, device
        self.tick0, self.admit0 = engine.tick, engine.admit
        self.armed = False
        self.stage = 0  # 1: device stretch, 2: the host operators' stretch
        self.done = threading.Event()
        self.live: list[list[int]] = []
        self.buckets: list[int] = []
        self.count = 0
        engine.tick, engine.admit = self.tick, self.admit

    def _start(self, host_ops: bool) -> None:
        from torch.profiler import profile

        self.prof = profile(activities=devices.activities(host_ops))
        self.prof.__enter__()
        self.count = 0
        self.t0 = time.perf_counter()

    def _stop(self):
        devices.sync(self.device)
        window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        return self.prof, window_s

    def tick(self):
        if self.armed and self.stage == 0:
            self.armed, self.stage = False, 1
            self._start(False)
        if self.stage == 1:
            self.live.append([s["position"] for s in self.engine.slot_states() if s["active"]])
        events = self.tick0()
        if self.stage:
            self.count += 1
        if self.stage and self.count == self.n:
            if self.stage == 1:
                self.device_trace = self._stop()
                self.stage = 2
                self._start(True)
            else:
                self.host_trace = self._stop()
                self.stage = 3
                self.done.set()
        return events

    def admit(self, prompt_ids, **knobs):
        if self.stage == 1:
            self.buckets.append(self.engine.bucket_for(len(prompt_ids)))
        return self.admit0(prompt_ids, **knobs)


def _client(serving, source: Traffic, records: list, stop: threading.Event, first_cut: float,
            errors: list):
    """One client of the closed loop.  It wakes twice a request, at the
    first token and at the end, so that the loop's own threads take little
    of the host from the engine's worker."""
    cut = first_cut
    try:
        while not stop.is_set():
            rec, req = source.draw(cut)
            cut = None
            rec.t_submit = time.perf_counter()
            handle = serving.submit(req)
            records.append(rec)
            stream = handle.tokens()
            first = next(stream, None)
            if first is not None:
                rec.t_first = time.perf_counter()
            rec.result = handle.result()
            rec.t_last = time.perf_counter()
            if first is not None:
                rec.tokens = [first, *stream]
    except Exception as exc:  # noqa: BLE001 -- reported as the run's failure
        if not stop.is_set():  # a submit racing the engine's close is no failure
            errors.append(repr(exc))


def run(conf: dict, traffic: dict, seed: int, seconds: float, traced: bool,
        t_start: float, fault=None, device="cuda", control: str | None = None) -> dict:
    from bpe_transformer_tpu_torch.serving.server import Request, ServingEngine

    dev = torch.device(device)
    model = conf["model"]
    cfg = model_config(conf)
    arch = spec.architecture(conf)
    act = getattr(torch, model.get("activation_dtype", "float32"))
    params = weights.make_params(arch.layout(model), seed, dev, dtype=act)
    host_params = [p.detach().to("cpu", copy=True) for p in weights.leaves(params)]
    serving = ServingEngine(params, cfg, slots=traffic["slots"], max_queue=traffic["max_queue"],
                            device=dev)
    engine = serving.engine
    del params
    if fault == "altered_token":
        _alter_tokens(engine, model["vocab_size"])
    token_log = TokenLog(engine)
    serving.start()
    try:
        # Warm up every prefill bucket the traffic reaches, greedy and sampled.
        lo, hi = traffic["prompt"]["min"], traffic["prompt"]["max"]
        warm = sorted({engine.bucket_for(n) for n in range(lo, hi + 1)})
        handles = []
        for b in warm:
            n = min(b, hi)
            for knobs in ({"temperature": 0.0},
                          {"temperature": traffic["temperature"], "top_p": traffic["top_p"]}):
                handles.append(serving.submit(Request(prompt_ids=tuple(range(1, n + 1)),
                                                      max_new_tokens=2, **knobs)))
        for h in handles:
            h.result(timeout=300)
        token_log.log.clear()

        source = Traffic(traffic, seed, model["vocab_size"])
        cuts = np.random.default_rng([int(seed), 4]).random(traffic["clients"])
        records: list[Record] = []
        stop, errors = threading.Event(), []
        clients = [threading.Thread(target=_client, daemon=True,
                                    args=(serving, source, records, stop, float(c), errors))
                   for c in cuts]
        for c in clients:
            c.start()
        time.sleep(traffic["warm_s"])
        t_open = time.time()

        # The window.
        ticks0 = engine.ticks
        t0 = time.perf_counter()
        time.sleep(seconds)
        t1 = time.perf_counter()
        ticks = engine.ticks - ticks0
        memory_peak = devices.peak_bytes(dev)

        stretch = None
        if traced:
            from torch.profiler import profile

            with profile(activities=devices.activities(True)):
                pass  # the profiler's first start, on the main thread
            tracer = StretchTracer(engine, traffic["trace_ticks"], dev)
            tracer.armed = True
            if not tracer.done.wait(timeout=120):
                raise RuntimeError("the traced stretch did not finish")
            stretch = trace.summarize(*tracer.device_trace)
            stretch["idle_gaps"] = trace.summarize(*tracer.host_trace)["idle_gaps"]
            stretch.update(live=tracer.live, buckets=tracer.buckets, n_slots=engine.n_slots)
        stop.set()
        # Requests submitted in the window are waited for until their first
        # token (a late answer is late, not wrong).
        deadline = time.perf_counter() + 60
        while time.perf_counter() < deadline and any(
                r.t_submit < t1 and r.t_first is None and r.result is None for r in list(records)):
            time.sleep(0.01)
    finally:
        serving.close()
    for c in clients:
        c.join(timeout=60)
    if errors:
        raise RuntimeError(f"a client failed: {errors[0]}")
    devices.sync(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    window = t1 - t0
    done = [r for r in records if r.result is not None and r.result.finish_reason == "length"]
    in_window = [r for r in records if t0 <= r.t_submit < t1]
    check = _check(arch, model, host_params, done, t0, t1, traffic, seed, dev, control)
    numbers = dict(check["numbers"])
    finished_in_window = [r for r in done if t0 <= r.t_last < t1]
    numbers["wrong_length"] = sum(len(r.tokens) != r.max_new for r in finished_in_window)
    emitted = [e for e in token_log.tokens() if t0 <= e[0] < t1]
    failed = sum(1 for r in in_window if r.t_first is None)
    return {
        "e2e": {"serve_tokens_per_s": len(emitted) / window, "setup_s": t_open - t_start},
        "numbers": numbers,
        "attempted": len(in_window),
        "failed": failed,
        "memory_peak_bytes": memory_peak,
        "window_s": window,
        "ticks": ticks,
        "records": records,
        "emitted": emitted,
        "t0": t0, "t1": t1,
        "trace": stretch,
        "notes": {"requests_in_window": len(in_window), "tokens_in_window": len(emitted),
                  "ticks": ticks, "window_s": window, **check["notes"]},
    }


def _alter_tokens(engine, vocab: int) -> None:
    """Fault (tests only): every token a tick produces is replaced by the
    next id."""
    from bpe_transformer_tpu_torch.serving.engine import TickEvent

    tick = engine.tick

    def altered():
        return [TickEvent(e.slot, (e.token + 1) % vocab, e.finished) for e in tick()]

    engine.tick = altered


def _check(arch, model: dict, host_params: list, done: list, t0: float, t1: float,
           traffic: dict, seed: int, dev, control: str | None) -> dict:
    """The architecture's reference over a seeded sample of the greedy
    requests the window finished, the longest among them: the widest gap
    below the reference's best logit of a served token.  With ``control`` (a lower
    precision of the reference's), the control stands in the program's
    place: at each position of the same prompts and served tokens the
    token it puts first is judged instead, and the program's own gap goes
    to the notes."""
    greedy = [r for r in done if r.greedy and t0 <= r.t_last < t1]
    if not greedy:
        return {"numbers": {"served_gap": math.inf}, "notes": {"checked_tokens": 0}}
    greedy.sort(key=lambda r: (len(r.prompt) + len(r.tokens), r.index))
    rng = np.random.default_rng([int(seed), 5])
    rest = greedy[:-1]
    picks = [greedy[-1]] + [rest[i] for i in sorted(
        rng.choice(len(rest), min(len(rest), traffic["check_requests"] - 1), replace=False))]
    params = weights.tree_from(arch.layout(model), host_params, dev, torch.float32)
    program, controlled, n_tokens = 0.0, 0.0, 0
    t_ref = time.perf_counter()
    with torch.no_grad(), reference.matmul_precision("fp32"):
        for r in picks:
            ids = torch.tensor([r.prompt + r.tokens[:-1]], device=dev)
            lg = arch.logits(params, ids, model)[0, len(r.prompt) - 1:]
            served = torch.tensor(r.tokens, device=dev)
            program = max(program, float(compare.served_gaps(lg, served).max()))
            n_tokens += len(r.tokens)
            if control is not None:
                with reference.matmul_precision(control):
                    low = arch.logits(params, ids, model, control)[0, len(r.prompt) - 1:]
                gap = compare.served_gaps(lg, low.argmax(-1))
                controlled = max(controlled, float(gap.max()))
    notes = {"checked_requests": len(picks), "checked_tokens": n_tokens,
             "reference_s": time.perf_counter() - t_ref}
    if control is None:
        return {"numbers": {"served_gap": program}, "notes": notes}
    notes["program_served_gap"] = program
    return {"numbers": {"served_gap": controlled}, "notes": {**notes, "control": control}}
