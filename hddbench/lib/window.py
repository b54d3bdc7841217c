"""The measured window: a closed loop of solves, one caller, each on a fresh
input, for a fixed time; the spans of the traced run; the sample of
answers kept for the check; the profiled solves of the traced run."""
from __future__ import annotations

import random
import time
from contextlib import contextmanager
from typing import NamedTuple

import torch

__all__ = ["Outcome", "sync", "Spans", "Sample", "run_window", "run_traced"]


class Outcome(NamedTuple):
    """What a system's solve returns to the harness."""

    u: torch.Tensor   # float64 solution, flat, [cell, vertex] order
    iterations: int   # PCG iterations
    sweeps: int       # float64 refinement sweeps (0 without refinement)
    ok: bool          # reached the configuration's tolerance


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Host-clock spans, each between two device synchronizations, in memory
    until the run ends: name -> [seconds]."""

    def __init__(self, device):
        self.device = device
        self.seconds: dict = {}

    @contextmanager
    def __call__(self, name: str):
        sync(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sync(self.device)
            self.seconds.setdefault(name, []).append(time.perf_counter() - t0)


class Sample:
    """The answers the check compares: a reservoir of ``k`` solves drawn
    from the seed, and the solve with the most iterations.  The slots are
    allocated before the window, and an answer is copied into one on the
    device, so keeping it costs the window no synchronization."""

    def __init__(self, k: int, seed: int, like: torch.Tensor):
        self.k = int(k)
        self.rng = random.Random(int(seed) ^ 0x5EED)
        self.slots = torch.empty((self.k + 1,) + tuple(like.shape), dtype=like.dtype,
                                 device=like.device)
        self.index = [None] * (self.k + 1)  # solve index held by each slot
        self.longest = -1

    def offer(self, i: int, u: torch.Tensor, iterations: int) -> None:
        slot = i if i < self.k else self.rng.randrange(i + 1)
        if slot < self.k:
            self.slots[slot].copy_(u)
            self.index[slot] = i
        if iterations > self.longest:
            self.longest = iterations
            self.slots[self.k].copy_(u)
            self.index[self.k] = i

    def kept(self):
        """[(solve index, answer)] without repeats."""
        seen, out = set(), []
        for i, u in zip(self.index, self.slots):
            if i is not None and i not in seen:
                seen.add(i)
                out.append((i, u))
        return out


def run_window(system, traffic, seconds: float, device, sample: Sample = None, spans=None):
    """Solves until ``seconds`` have passed; the solve that is running then
    ends the window.  Returns (window seconds, [per solve: seconds,
    iterations, sweeps, ok], [inputs])."""
    records, inputs = [], []
    sync(device)
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        inp = traffic.next()
        sync(device)
        t0 = time.perf_counter()
        out = system.solve(inp) if spans is None else system.solve_in_spans(inp, spans)
        sync(device)
        records.append({"seconds": time.perf_counter() - t0, "iterations": out.iterations,
                        "sweeps": out.sweeps, "ok": out.ok})
        if sample is not None:
            sample.offer(len(inputs), out.u, out.iterations)
        inputs.append(inp)
    return time.perf_counter() - start, records, inputs


def _solved(system, inputs, device):
    """(seconds, [per solve: iterations, sweeps]) of solving ``inputs``."""
    outs = []
    sync(device)
    t0 = time.perf_counter()
    for inp in inputs:
        out = system.solve(inp)
        outs.append({"iterations": out.iterations, "sweeps": out.sweeps})
    sync(device)
    return time.perf_counter() - t0, outs


def _profiled(system, inputs, device, activities):
    with torch.profiler.profile(activities=activities) as prof:
        window, outs = _solved(system, inputs, device)
    return prof.profiler.kineto_results.events(), window, outs


def run_traced(system, traffic, solves: int, device):
    """``solves`` timed calls solved untraced, then the same inputs again
    under ``torch.profiler`` with device activity alone (what the busy
    union and the kernels' times are read from: the same work as the
    untraced pass, whose time the idle share is taken over, since even
    this trace slows the host's dispatch), then ``solves`` fresh ones with
    the host's operations recorded too (what labels the idle gaps only).
    Returns (the untraced pass's seconds, the second pass's raw events, its
    window's seconds, [per solve: iterations, sweeps], the third pass's raw
    events)."""
    P = torch.profiler.ProfilerActivity
    inputs = [traffic.next() for _ in range(2 * solves)]
    untraced_s, _ = _solved(system, inputs[:solves], device)
    alone = P.CUDA if torch.device(device).type == "cuda" else P.CPU  # the tests: no card
    events, window, outs = _profiled(system, inputs[:solves], device, [alone])
    labelled, _, _ = _profiled(system, inputs[solves:], device, [P.CPU, P.CUDA])
    return untraced_s, events, window, outs, labelled
