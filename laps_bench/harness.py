"""One run of a benchmark cell: set-up, the measured window, the drain,
the metrics, and the comparison with the plain reference that decides
``correct``.

A cell is found by name: ``BENCHMARK.json`` names its configuration file
and traffic mix, ``cells/<cell>.json`` holds its load and its check, and
each metric is read by ``metrics/<metric>.py``.  The configuration file
names its plain reference under ``references/``, which also makes the
seeded weights that the program and the reference both read, and its
model family under ``models/`` (``family_module``), which gives the
program's model, the pool's size and the yardstick the readers count
with.

The program is ``repro_torch``'s serving path: a ``ServeLoop`` over an
``Engine`` on the paged pool with the radix prefix index, the packed
token-bucket executor and the paged decode executor (every step a CUDA
graph replay), scheduled by the ``pla_full`` policy (dual queue, AWD
waiting window, long prefills in chunks of C_l).  The harness submits
each turn when it is due, calls ``loop.tick()`` itself and stamps every
output token as it appears in ``loop.generated``.  Around the program's
calls it records what each step ran (the segments handed to the
executors), the tick times and, with ``--trace 1``, profiler spans.
"""
from __future__ import annotations

import dataclasses
import gc
import heapq
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from laps_bench import arith, workload
from laps_bench import trace as trace_mod

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCH = os.path.basename(HERE)   # the benchmark's directory in a checkout
DRAIN_CAP_S = 60.0         # a turn due in the window with no first token
                           # this long after the window closes has failed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # whole top-level names
WARMUP_SESSION = 1 << 40   # engine session ids of the warm-up trace
RUN_SESSION = 1 << 41      # and of the run's turns
clock = time.monotonic


# ------------------------------------------------------------------ spec


def _load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_spec(workload_name: str, root: str = ROOT) -> Dict:
    """Everything a run of ``workload_name`` reads, found by name in the
    checkout at ``root``."""
    here = os.path.join(root, BENCH)
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload_name not in cells:
        raise KeyError(f"no workload {workload_name!r} in BENCHMARK.json")
    cell = cells[workload_name]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    e2e = [m for m in bench["end_to_end"]
           if workload_name in m.get("workloads", [workload_name])]
    layer = [m for m in bench["per_layer"]
             if workload_name in m.get("workloads", [workload_name])]
    config = _load_json(os.path.join(root, conf["file"]))
    return {
        "name": workload_name,
        "chips": int(cell["chips"]),
        "config": config,
        "family": family_module(config, root),
        "mix": _load_json(os.path.join(here, "traffic",
                                       cell["traffic"] + ".json")),
        "cell": _load_json(os.path.join(here, "cells",
                                        workload_name + ".json")),
        "end_to_end": e2e, "per_layer": layer,
    }


def _module(path: str, name: str):
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    sys.modules[name] = mod        # a dataclass looks its module up there
    mod_spec.loader.exec_module(mod)
    return mod


def family_module(config: Dict, root: str = ROOT):
    """``models/<config["model"]>.py`` (``dense`` without the key): all
    that the harness knows of a model's shape.  It gives

    - ``program_config(config)``: the program's ``ModelConfig``;
    - ``page_bytes(config, page_size)``: every device byte one page of the
      program's pool holds;
    - ``pool(config, free_bytes)``: the ``EngineConfig`` fields that size
      the program's caches from the bytes the card has left after the
      weights and ``headroom_gib`` (``num_pages``, and any other pool the
      family keeps); ``serving.num_pages`` in the configuration overrides
      it;
    - ``yardstick(config)``: what the metric readers count with: the
      attention widths ``arith.prefill_call`` and ``arith.decode_call``
      read (``heads``, ``kv_heads``, ``head_dim``, ``elem_bytes``), the
      layers that launch those kernels (``attn_layers``), and
      ``step_flops(segments)``, the model FLOPs of one step over segments
      of (new tokens, history).

    A family module loads nothing of the program but its
    ``ModelConfig``."""
    name = config.get("model", "dense")
    return _module(os.path.join(root, BENCH, "models", name + ".py"),
                   "laps_bench_model_" + name)


def reference_module(config: Dict):
    return _module(os.path.join(HERE, "references",
                                config["reference"] + ".py"),
                   "laps_bench_reference_" + config["reference"])


def metric_reader(name: str):
    """``metrics/<name>.py``; a quantity split by the end-to-end metric it
    moves in each kind of cell (``queue_wait_p90_ms.closed``) is read by
    its base's reader unless it has one of its own."""
    path = os.path.join(HERE, "metrics", name + ".py")
    if not os.path.exists(path):
        path = os.path.join(HERE, "metrics", name.split(".")[0] + ".py")
    return _module(path, "laps_bench_metric_" + name.replace(".", "_"))


# --------------------------------------------------------------- records


@dataclasses.dataclass
class Turn:
    conv: int
    index: int
    due: float
    prompt: np.ndarray
    out_len: int
    sid: int = -1
    submit: Optional[float] = None
    req: Any = None
    times: List[float] = dataclasses.field(default_factory=list)
    outputs: Optional[List[int]] = None     # set when the turn finished

    @property
    def first(self) -> Optional[float]:
        return self.times[0] if self.times else None

    @property
    def dispatch(self) -> Optional[float]:
        return getattr(self.req, "dispatch_time", None)


@dataclasses.dataclass
class Tick:
    t0: float
    t1: float
    prefill: List[List[Tuple[int, int]]]    # each packed dispatch's
                                            # (new tokens, history) segments
    decode: List[List[int]]                 # each decode dispatch's lengths
    traced: bool = False

    @property
    def kind(self) -> str:
        if self.prefill:
            return "prefill"
        return "decode" if self.decode else "idle"


@dataclasses.dataclass
class Record:
    """What the metric readers read."""
    seconds: float
    t_start: float
    t_end: float
    setup_s: float
    turns: List[Turn]
    ticks: List[Tick]
    stats0: Dict
    stats1: Dict
    graphs0: int
    graphs1: int
    shape: Any                  # the family's yardstick
    peak: Dict
    trace: Optional[trace_mod.Summary] = None
    lateness: List[float] = dataclasses.field(default_factory=list)
    drain_s: float = 0.0
    memory_peak: int = 0
    peak_tokens: int = 0
    peak_pages: int = 0
    summary_s: float = 0.0
    gc_pauses: List[Tuple[int, float]] = dataclasses.field(
        default_factory=list)

    def in_window(self) -> List[Turn]:
        return [t for t in self.turns if self.t_start <= t.due < self.t_end]


# ---------------------------------------------------------------- probes


class Probe:
    """Records, around the program's calls, what each tick dispatched:
    the segments of every packed step (from the executor's cu_seqlens,
    q_offsets and kv_lengths) and the key counts of every decode step's
    live rows; with a tracer, a profiler span around each call."""

    def __init__(self, engine, policy, tracer: Optional[trace_mod.Tracer]):
        self.tracer = tracer
        self.prefill: List[List[Tuple[int, int]]] = []
        self.decode: List[List[int]] = []
        self._live = 0
        self._wrapped: List[Tuple[Any, str]] = []
        px, dx = engine.packed_executor, engine.decode_executor
        self._wrap(px, "mixed_step_paged", self._on_packed)
        self._wrap(dx, "decode_paged", self._on_decode)
        self._wrap(engine, "decode_batch", self._on_decode_batch,
                   "engine.decode_batch")
        self._wrap(engine, "step_mixed", None, "engine.step_mixed")
        self._wrap(policy, "next_work", None, "scheduler.next_work")

    def _wrap(self, obj, name: str, note: Optional[Callable],
              span: Optional[str] = None) -> None:
        fn = getattr(obj, name)
        sig = inspect.signature(fn)
        span = span or f"{type(obj).__name__}.{name}"
        tracer = self.tracer

        def wrapped(*args, **kw):
            if note is not None:
                note(sig.bind(*args, **kw).arguments)
            if tracer is not None and tracer.active:
                with tracer.span(span):
                    return fn(*args, **kw)
            return fn(*args, **kw)

        setattr(obj, name, wrapped)
        self._wrapped.append((obj, name))

    def close(self) -> None:
        """Take the wrappers off again."""
        for obj, name in self._wrapped:
            delattr(obj, name)
        self._wrapped = []

    def _on_packed(self, a: Dict) -> None:
        cu = np.asarray(a["cu_seqlens"])
        q = np.diff(cu)
        h = np.asarray(a["q_offsets"])
        self.prefill.append([(int(q[i]), int(h[i]))
                             for i in range(len(q)) if q[i] > 0])

    def _on_decode_batch(self, a: Dict) -> None:
        self._live = len(a["sessions"])

    def _on_decode(self, a: Dict) -> None:
        self.decode.append([int(x) for x in
                            np.asarray(a["kv_lengths"])[:self._live]])

    def take(self) -> Tuple[List, List]:
        out = (self.prefill, self.decode)
        self.prefill, self.decode = [], []
        return out


# ------------------------------------------------------------ the system


class System:
    """The program under test, built from a config's ``serving`` section
    and its model family (``family_module``): the engine (its caches
    sized by the family to what the card holds after the weights, less
    ``headroom_gib``), and a fresh policy and loop per phase."""

    def __init__(self, config: Dict, weights: Dict, device, family):
        from repro_torch.serving.engine import Engine, EngineConfig
        sv = config["serving"]
        self.sv = sv
        dev = torch.device(device)
        if sv.get("num_pages"):
            sizes = {"num_pages": int(sv["num_pages"])}
        else:
            free, _ = torch.cuda.mem_get_info(dev)
            sizes = family.pool(config, free - sv["headroom_gib"] * 2**30)
        self.num_pages = sizes["num_pages"]
        ecfg = EngineConfig(
            num_slots=int(sv["num_slots"]), max_len=int(sv["max_len"]),
            chunk_tokens=int(sv["chunk_tokens"]), measure=True,
            packed=True, paged_kv=True, prefix_cache=True,
            keep_last_logits=False, page_size=int(sv["page_size"]),
            token_buckets=tuple(sv["token_buckets"]),
            decode_buckets=tuple(sv["decode_buckets"]), **sizes)
        self.engine = Engine(family.program_config(config), weights, ecfg,
                             device=dev)

    def new_loop(self):
        from repro_torch.core import H200_QWEN32B, Variant, make_policy
        from repro_torch.core.awd import AWDConfig
        from repro_torch.serving.loop import ServeLoop
        eng = self.engine
        awd = AWDConfig(packed=True, token_buckets=eng.ecfg.token_buckets,
                        packed_max_seqs=eng.packed_executor.max_seqs)
        policy = make_policy(Variant(self.sv["variant"]), H200_QWEN32B,
                             threshold=self.sv["threshold"],
                             chunk_tokens=int(self.sv["chunk_tokens"]),
                             awd_cfg=awd)
        return ServeLoop(eng, policy, slo_ttft=self.sv["slo_ttft_s"],
                         clock=clock)

    def graphs(self) -> int:
        return self.engine.graph_stats()["graphs"]


def warm_up(system: System, vocab: int, seed: int) -> None:
    """A throw-away trace that reaches every token bucket and decode rung
    the cell's traffic can reach, so their step graphs are captured
    before the window: one prompt per token bucket, filled past the
    bucket below, then as many sessions as the top decode rung decoding
    together with budgets 1, 2, ..., so the live count falls through
    every rung."""
    eng = system.engine
    rng = np.random.default_rng([int(seed) % 2**63, 3])
    loop = system.new_loop()
    sid = WARMUP_SESSION
    lo = 0
    for b in eng.packed_executor.token_buckets:
        n = max(lo + 1, (3 * b) // 4)
        lo = b
        loop.submit(sid, rng.integers(1, vocab, n), decode_tokens=0)
        loop.run_until_idle()
        loop.close_session(sid)
        sid += 1
    rungs = min(max(eng.decode_executor.decode_buckets),
                int(system.sv["num_slots"]))
    sids = []
    for i in range(rungs):
        loop.submit(sid, rng.integers(1, vocab, 16), decode_tokens=i + 1)
        sids.append(sid)
        sid += 1
    loop.run_until_idle()
    for s in sids:
        loop.close_session(s)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)


# ---------------------------------------------------------------- window


class GCPauses:
    """The interpreter's garbage collections while open, as (generation,
    seconds): a full collection walks every object the host holds, and
    the loop waits for it."""

    def __init__(self):
        self.pauses: List[Tuple[int, float]] = []
        self._t = 0.0
        gc.callbacks.append(self._note)

    def _note(self, phase: str, info: Dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.pauses.append((info["generation"],
                                time.perf_counter() - self._t))

    def close(self) -> None:
        gc.callbacks.remove(self._note)


class Driver:
    """Serves a plan for one window: submits each turn when due, ticks the
    loop, stamps tokens, then drains until every turn due in the window
    has its first token (or ``DRAIN_CAP_S`` passes)."""

    def __init__(self, loop, probe: Probe, plan: workload.Plan,
                 tokens: workload.Tokens, seconds: float,
                 tracer: Optional[trace_mod.Tracer], trace_s: float):
        self.loop, self.probe = loop, probe
        self.plan, self.tokens = plan, tokens
        self.seconds = seconds
        self.tracer, self.trace_s = tracer, trace_s
        self.turns: List[Turn] = []
        self.ticks: List[Tick] = []
        self.active: Dict[int, Turn] = {}
        self.conv_tokens: Dict[int, np.ndarray] = {}
        self.conv_client: Dict[int, int] = {}
        self.client_next: Dict[int, int] = {}
        self.heap: List[Tuple[float, int, int, int]] = []
        self.lateness: List[float] = []
        self.peak_tokens = 0       # most tokens held by submitted turns
        self.peak_pages = 0        # most pool pages in use at once
        self._seq = 0
        self._sid = RUN_SESSION

    # -- the plan
    def _push(self, due: float, conv: int, index: int) -> None:
        if due < self.t_end:
            heapq.heappush(self.heap, (due, self._seq, conv, index))
            self._seq += 1

    def _open_conv(self, conv: int, due: float) -> None:
        system = self.plan.sessions[conv].system
        self.conv_tokens[conv] = self.tokens.system[:system].copy()
        self._push(due, conv, 0)

    def _submit(self, now: float, conv: int, index: int, due: float) -> None:
        shape = self.plan.sessions[conv].turns[index]
        new = self.tokens.turn(conv, index, shape.new_tokens)
        prompt = np.concatenate([self.conv_tokens[conv], new])
        turn = Turn(conv, index, due, prompt, shape.out_tokens,
                    sid=self._sid, submit=now)
        self._sid += 1
        turn.req = self.loop.submit(turn.sid, prompt,
                                    decode_tokens=shape.out_tokens - 1)
        self.turns.append(turn)
        self.active[turn.sid] = turn
        self.lateness.append(now - due)

    def _finished(self, turn: Turn, now: float) -> None:
        del self.active[turn.sid]
        self.loop.close_session(turn.sid)
        conv = turn.conv
        self.conv_tokens[conv] = np.concatenate(
            [turn.prompt, np.asarray(turn.outputs, np.int64)])
        shape = self.plan.sessions[conv]
        nxt = now + shape.turns[turn.index].think_s
        if turn.index + 1 < len(shape.turns):
            self._push(nxt, conv, turn.index + 1)
        elif conv in self.conv_client:
            self._next_session(self.conv_client[conv], nxt)

    def _next_session(self, client: int, due: float) -> None:
        lst = self.plan.clients[client]
        i = self.client_next.get(client, 0)
        if i < len(lst):
            self.client_next[client] = i + 1
            self.conv_client[lst[i]] = client
            self._open_conv(lst[i], due)

    # -- the loop
    def _stamp(self, now: float) -> None:
        gen = self.loop.generated
        self.peak_tokens = max(self.peak_tokens, sum(
            len(t.prompt) + len(t.times) for t in self.active.values()))
        arena = self.loop.engine.arena
        self.peak_pages = max(self.peak_pages,
                              arena.num_pages - arena.free_pages)
        for turn in list(self.active.values()):
            got = gen.get(turn.sid)
            if not got or len(got) == len(turn.times):
                continue
            turn.times.extend([now] * (len(got) - len(turn.times)))
            if len(got) >= turn.out_len:
                turn.outputs = [int(t) for t in got[:turn.out_len]]
                self._finished(turn, now)

    def _waiting_first(self) -> int:
        return sum(1 for t in self.turns
                   if t.due < self.t_end and not t.times)

    def run(self) -> None:
        t0 = clock()
        self.t_start, self.t_end = t0, t0 + self.seconds
        if self.plan.arrivals is not None:
            for conv, at in enumerate(self.plan.arrivals):
                self._open_conv(conv, t0 + at)
        else:
            for c in range(len(self.plan.clients)):
                self._next_session(c, t0)
        # the trace covers the window's last ``trace_s`` seconds and the
        # drain: the profiler's stop, which takes seconds, comes after
        tr_on = self.t_end - self.trace_s
        loop, tracer = self.loop, self.tracer
        while True:
            now = clock()
            if tracer is not None and not tracer.active and now >= tr_on \
                    and now < self.t_end:
                tracer.start()
            while self.heap and self.heap[0][0] <= now:
                due, _, conv, index = heapq.heappop(self.heap)
                self._submit(now, conv, index, due)
            if now >= self.t_end and (self._waiting_first() == 0 or
                                      now >= self.t_end + DRAIN_CAP_S):
                break
            if loop.has_work:
                traced = tracer is not None and tracer.active
                a = clock()
                if traced:
                    with tracer.span("loop.tick"):
                        did, wake = loop.tick()
                else:
                    did, wake = loop.tick()
                b = clock()
                pre, dec = self.probe.take()
                if pre or dec:
                    self.ticks.append(Tick(a, b, pre, dec, traced))
                self._stamp(b)
                if did:
                    continue
                nxt = wake if wake is not None else clock() + 0.0005
            else:
                nxt = clock() + 0.002
            if self.heap:
                nxt = min(nxt, self.heap[0][0])
            pause = nxt - clock()
            if pause > 0:
                time.sleep(min(pause, 0.002))


# ---------------------------------------------------------------- check


def pick_sequences(turns: List[Turn], rng: np.random.Generator,
                   served_target: int, max_tokens: int,
                   min_conversations: int = 1) -> List[Dict]:
    """The sample judged against the reference: whole conversations up to
    their last finished turn, the one holding the longest finished turn
    first, then others in an order drawn from the seed (so each seed
    judges other sessions, served at other times), until
    ``served_target`` served tokens and ``min_conversations``
    conversations are in; one that would pass ``max_tokens`` tokens in
    all is passed over.  Each conversation's sequence covers every
    finished turn in it: each turn's prompt holds the earlier turns'
    prompts and replies."""
    done: Dict[int, List[Turn]] = {}
    for t in turns:
        if t.outputs is not None:
            done.setdefault(t.conv, []).append(t)
    if not done:
        return []
    longest = max((t for ts in done.values() for t in ts),
                  key=lambda t: len(t.prompt) + t.out_len)
    rest = [c for c in sorted(done) if c != longest.conv]
    order = [longest.conv] + [rest[i] for i in rng.permutation(len(rest))]
    out, served, total = [], 0, 0
    for conv in order:
        ts = sorted(done[conv], key=lambda t: t.index)
        ts = ts[:next((i for i, t in enumerate(ts) if t.index != i),
                      len(ts))]                    # finished in order
        last = ts[-1]
        seq = np.concatenate([last.prompt,
                              np.asarray(last.outputs[:-1], np.int64)])
        if out and total + len(seq) > max_tokens:
            continue
        pos, srv = [], []
        for t in ts:
            p = len(t.prompt)
            pos.extend(range(p - 1, p - 1 + t.out_len))
            srv.extend(t.outputs)
        out.append({"tokens": seq, "positions": np.asarray(pos),
                    "served": np.asarray(srv), "conv": conv})
        served += len(srv)
        total += len(seq)
        if served >= served_target and len(out) >= min_conversations:
            break
    return out


def gap_readings(gaps: torch.Tensor) -> Dict[str, float]:
    """The numbers compared: the widest gap between a served token's
    reference logit and the reference's best, and the mean gap over the
    served tokens; with the share of tokens that were not the best."""
    if not len(gaps):
        return {"widest_logit_gap": float("inf"),
                "mean_logit_gap": float("inf"), "off_best_share": 1.0}
    return {"widest_logit_gap": float(gaps.max()),
            "mean_logit_gap": float(gaps.mean()),
            "off_best_share": float((gaps > 0).float().mean())}


def check_history(turns: List[Turn]) -> None:
    """Each later turn's prompt holds the earlier turn's prompt and its
    whole reply, as the generator built it."""
    by = {(t.conv, t.index): t for t in turns}
    for (c, i), t in by.items():
        prev = by.get((c, i - 1))
        if prev is not None and prev.outputs is not None:
            n = len(prev.prompt) + prev.out_len
            want = np.concatenate([prev.prompt, prev.outputs])
            if not np.array_equal(t.prompt[:n], want):
                raise AssertionError(f"conversation {c} turn {i}: history")


# ------------------------------------------------------------------ run


def _card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "?"
    except (OSError, subprocess.SubprocessError):
        return "?"


def prepare(spec: Dict, seed: int, device) -> Tuple[Any, Dict, System]:
    """Set-up: the reference module, the seeded weights on the device, the
    engine over them, and the warm-up trace."""
    config = spec["config"]
    ref = reference_module(config)
    ref.reference_config_check(config)
    weights = ref.make_weights(config, config["init"], seed, device)
    system = System(config, weights, device, spec["family"])
    warm_up(system, int(config["vocab_size"]), seed)
    return ref, weights, system


def serve(spec: Dict, system: System, seed: int, seconds: float,
          load: Dict, tracer: Optional[trace_mod.Tracer],
          setup_s: float = 0.0) -> Record:
    """One window of the cell's traffic at ``load`` on a fresh loop and
    policy, and its drain."""
    config, mix = spec["config"], spec["mix"]
    sv = config["serving"]
    dev = system.engine.device
    # a session's whole conversation stays two tokens inside max_len,
    # the most the engine admits
    plan = workload.plan(mix, load, seconds, int(sv["max_len"]) - 2)
    tokens = workload.Tokens(seed, int(config["vocab_size"]),
                             int(mix.get("system_prompt", 0)))
    loop = system.new_loop()
    probe = Probe(system.engine, loop.policy, tracer)
    trace_s = min(float(spec["cell"].get("trace_seconds", 10.0)), seconds)
    drv = Driver(loop, probe, plan, tokens, seconds, tracer, trace_s)
    stats0, graphs0 = system.engine.stats(), system.graphs()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    pauses = GCPauses()
    drv.run()
    pauses.close()
    probe.close()
    drain_s = clock() - drv.t_end
    if tracer is not None and tracer.active:
        tracer.stop()
    t_sum = clock()
    rec = Record(seconds=seconds, t_start=drv.t_start, t_end=drv.t_end,
                 setup_s=setup_s, turns=drv.turns, ticks=drv.ticks,
                 stats0=stats0, stats1=system.engine.stats(),
                 graphs0=graphs0, graphs1=system.graphs(),
                 shape=spec["family"].yardstick(config),
                 peak=(arith.peaks(torch.cuda.get_device_name(dev))
                       if dev.type == "cuda" else {}),
                 trace=tracer.summary() if tracer else None)
    rec.summary_s = clock() - t_sum
    rec.lateness = drv.lateness
    rec.gc_pauses = pauses.pauses
    rec.peak_tokens = drv.peak_tokens
    rec.peak_pages = drv.peak_pages
    rec.drain_s = drain_s
    rec.memory_peak = (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else 0)
    return rec


def run(spec: Dict, seed: int, seconds: float, trace: bool,
        t_process: float, device: str = "cuda", control: bool = False,
        log=None) -> Dict:
    """One run of the cell ``spec`` (``load_spec``).  Returns the result
    line's dict.  With ``control`` the reference's lower-precision
    control is judged in the program's place, by the same limits, on the
    same sequences (the program's own readings go to the log), and
    ``correct`` has to come out false.  ``log(msg)`` receives the lines
    for standard error."""
    log = log or (lambda m: print(m, file=sys.stderr, flush=True))
    config, cell = spec["config"], spec["cell"]
    load = cell["load"]
    dev = torch.device(device)
    ref, weights, system = prepare(spec, seed, dev)
    tracer = trace_mod.Tracer(dev) if trace else None
    if tracer is not None:
        tracer.prime()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = clock() - t_process
    log(f"[laps_bench] {spec['name']} seed {seed}: set-up {setup_s:.3f} s, "
        f"{system.num_pages} KV pages of "
        f"{config['serving']['page_size']} tokens, {system.graphs()} step "
        f"graphs captured in warm-up, load {load}")
    rec = serve(spec, system, seed, seconds, load, tracer, setup_s)
    due = rec.in_window()
    failed = sum(1 for t in due if not t.times)
    evicted = rec.stats1["pages_evicted"] - rec.stats0["pages_evicted"]
    late = np.asarray(rec.lateness or [0.0])
    log(f"[laps_bench] window {seconds} s + drain {rec.drain_s:.3f} s: "
        f"{len(due)} turns due, {failed} without a first token, "
        f"{len(rec.ticks)} ticks; generator lateness mean "
        f"{late.mean() * 1e3:.3f} ms p90 "
        f"{np.percentile(late, 90) * 1e3:.3f} ms max "
        f"{late.max() * 1e3:.3f} ms; {evicted} pages evicted; at most "
        f"{rec.peak_tokens} tokens held by the turns in flight; live "
        f"captures {rec.graphs1 - rec.graphs0}")
    full = [s for g, s in rec.gc_pauses if g == 2]
    log(f"[laps_bench] garbage collections in the window and drain: "
        f"{len(rec.gc_pauses)}, {sum(s for _, s in rec.gc_pauses):.3f} s; "
        f"{len(full)} full, longest {max(full, default=0.0):.3f} s")
    if rec.trace is not None:
        log(f"[laps_bench] traced {rec.trace.window_s:.3f} s: device busy "
            f"{rec.trace.busy_s:.3f} s, traced ticks {rec.trace.tick_s:.3f} "
            f"s of which idle {rec.trace.tick_idle_s:.3f} s; the profiler's "
            f"stop, after the drain, took {rec.trace.stop_s:.3f} s and "
            f"reading its events {rec.summary_s:.3f} s")

    names = [m["name"] for m in (spec["per_layer"] if trace
                                 else spec["end_to_end"])]
    units = {m["name"]: m["unit"] for m in spec["per_layer"]
             + spec["end_to_end"]}
    metrics = {}
    for name in names:
        value = metric_reader(name).read(rec)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}

    # the program's state goes before the reference runs
    system_pages = system.num_pages
    del system
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    chk = cell["check"]
    check_history(rec.turns)
    seqs = pick_sequences(rec.turns, np.random.default_rng(
        [int(seed) % 2**63, 4]), int(chk["served_tokens"]),
        int(chk["max_tokens"]), int(chk.get("min_conversations", 1)))
    t_ref = clock()
    judged = ref.judge(weights, config, seqs, dev,
                       precision=chk["control_precision"] if control else None)
    readings = gap_readings(judged["gaps"])
    # the pool is reserved whole at set-up: what the traffic used of the
    # card is the peak less the pages that no turn ever held
    unused = (system_pages - rec.peak_pages) * spec["family"].page_bytes(
        config, int(config["serving"]["page_size"]))
    log(f"[laps_bench] reference over {len(seqs)} conversations, "
        f"{sum(len(s['tokens']) for s in seqs)} tokens, in "
        f"{clock() - t_ref:.3f} s; card "
        f"{_card_line() if dev.type == 'cuda' else 'cpu'}; memory peak "
        f"{rec.memory_peak} B; pool pages in use at most {rec.peak_pages} "
        f"of {system_pages}, so memory in use at most "
        f"{max(rec.memory_peak - unused, 0)} B; served tokens off the "
        f"reference's best: {readings['off_best_share']!r}")
    if control:
        # the control in the program's place: the tokens the reference
        # puts first in the lower precision are judged as served ones
        for name in ("widest_logit_gap", "mean_logit_gap"):
            log(f"[laps_bench] the program's {name} {readings[name]!r}")
        judged = {"gaps": judged["control"]}
        readings = gap_readings(judged["gaps"])
        log(f"[laps_bench] control: the reference in "
            f"{chk['control_precision']} judged in the program's place")
    check = {name: {"value": readings[name], "limit": limit}
             for name, limit in chk["limits"].items()}
    check["served_tokens_compared"] = {"value": len(judged["gaps"]),
                                       "limit": chk["served_tokens_min"]}
    correct = all(check[n]["value"] <= check[n]["limit"]
                  for n in chk["limits"]) and \
        len(judged["gaps"]) >= chk["served_tokens_min"]
    for name in ("widest_logit_gap", "mean_logit_gap"):
        if name not in chk["limits"]:
            log(f"[laps_bench] {name} {readings[name]!r} (not compared)")
    result = {"correct": bool(correct), "attempted": len(due),
              "failed": failed, "metrics": metrics,
              "device": _device(dev, rec.memory_peak, rec, trace)}
    if trace and rec.trace is not None:
        result["breakdown"] = rec.trace.breakdown()
    result["check"] = check
    for name, c in check.items():
        least = name == "served_tokens_compared"
        log(f"check {name} {c['value']!r} limit {c['limit']!r} "
            f"({'at least' if least else 'at most'})")
    return result


def _device(dev, mem_peak: int, rec: Record, trace: bool) -> Dict:
    if dev.type != "cuda":
        out = {"platform": "cpu", "kind": "cpu", "count": 0,
               "memory_peak_bytes": 0}
    else:
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
               "count": 1, "memory_peak_bytes": int(mem_peak)}
    if trace and rec.trace is not None:
        out["busy_s"] = rec.trace.busy_s
        out["window_s"] = rec.trace.window_s
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})
