"""Window driver ``rollout``: the port's fused random-policy rollout
kernel (``ops.checkers_rollout`` B2 or ``ops.roadway_rollout`` B4,
``engine`` in the cell's file) called back to back, B instances x T
steps a call, call i with the Philox seed ``--seed`` + i, each call
ended by reading its reward sum on the host, as the reference's
``bench.py`` times it.  ``rollout_env_steps_per_s`` is B x T x the calls
completed in the window over the window's seconds.

Set-up: the kernel's build (``build/`` in the checkout) and one call at
the cell's sizes.  With ``--trace 1`` ``traced_calls`` more calls run
after the window under the profiler, each in the span "call" and its
host read in "host_read".

Correctness: each call's answers (reward sum and episode count) of a
sample of ``checked_instances`` instances drawn from the seed are kept
as the window runs; once it has closed, the plain reference
(``reference/rollout.py``) recomputes them for two of the calls (the
last, and one drawn from the seed) and every answer is compared
exactly."""

from __future__ import annotations

import os
import time

import torch

from benchmark import harness
from benchmark.counts import rollout_ops as ro
from benchmark.reference import rollout as rr

SPAN_NAMES = ("call", "host_read")


def _program(ctx):
    """(rollout function, its game) in the port's own types."""
    from cm3_tpu_torch.core import config as pcfg

    w = ctx.workload
    if w["engine"] == "checkers":
        from cm3_tpu_torch.envs import checkers_packed as cp
        from cm3_tpu_torch.ops import checkers_rollout as kr

        spec = rr.checkers_spec(ctx.config, w)
        env = pcfg.CheckersEnvConfig(
            n_rows=spec.height, n_columns=spec.width - 1,
            n_obs=ctx.config["stage_file"]["init"]["n_obs"],
            agents_r=tuple(ctx.config["stage_file"]["init"]["agents_r"]),
            agents_c=tuple(ctx.config["stage_file"]["init"]["agents_c"]),
            n_agents=len(spec.init_pos), max_steps=spec.max_steps)
        return kr.rollout_prng, cp.make_spec(env, spec.goal_green)
    if w["engine"] == "roadway":
        from cm3_tpu_torch.ops import roadway_rollout as kr

        ref = rr.roadway_config(ctx.config, w)
        fields = {k: getattr(ref, k) for k in ref.__dataclass_fields__}
        return kr.rollout_prng, pcfg.RoadwayEnvConfig(**fields)
    raise ValueError(w["engine"])


class Run:
    def __init__(self, ctx):
        self.ctx = ctx
        w = ctx.workload
        self.batch, self.steps = w["batch"], w["steps"]
        gen = torch.Generator().manual_seed(ctx.seed)
        k = min(w["checked_instances"], self.batch)
        self.idx = torch.randperm(self.batch, generator=gen)[:k].sort().values
        self.gen = gen

    def _call(self, fn, game, i):
        return fn(game, self.batch, self.steps, self.ctx.seed + i,
                  device=self.ctx.device)

    def run(self):
        ctx = self.ctx
        fn, game = _program(ctx)
        idx = self.idx.to(ctx.device)
        rew, _ = self._call(fn, game, -1)          # build + warm-up
        float(rew.sum())
        kept = []
        t0 = time.perf_counter()
        i = 0
        while True:
            rew, ep = self._call(fn, game, i)
            float(rew.sum())
            kept.append((rew[idx], ep[idx]))
            i += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        seconds = time.perf_counter() - t0
        self.calls, self.kept = i, kept
        self.attempted, self.failed = i, 0
        self.setup_s = t0 - ctx.t_process
        self.metrics = {
            "rollout_env_steps_per_s": self.batch * self.steps * i / seconds,
            "setup_s": self.setup_s}
        self.trace = None
        if ctx.trace:
            self.trace = self._traced(fn, game, i, seconds)
        return self

    def _traced(self, fn, game, first, window_s):
        ctx = self.ctx
        n = ctx.workload["traced_calls"]
        ep_sums = []
        with harness.profile(ctx.out_dir, ctx.device) as prof:
            with torch.profiler.record_function("window"):
                for i in range(first, first + n):
                    with torch.profiler.record_function("call"):
                        rew, ep = self._call(fn, game, i)
                    with torch.profiler.record_function("host_read"):
                        float(rew.sum())
                    ep_sums.append(ep.sum(dtype=torch.int64))
                harness.synchronize(ctx.device)
        path = os.path.join(ctx.out_dir, "trace.json")
        prof.export_chrome_trace(path)
        ops, spans, win = harness.reduce_trace(path, SPAN_NAMES, "window")
        os.remove(path)
        kernel = "checkers" if ctx.workload["engine"] == "checkers" \
            else "roadway"
        return harness.Trace(
            ops, spans, win,
            counters={"traced_calls": n, "window_calls": first,
                      "window_s": window_s, "kernel": kernel,
                      "resets_per_call": float(sum(int(e) for e in ep_sums))
                      / n},
            counts={"batch": self.batch, "steps": self.steps})

    def check(self):
        """Every kept answer of two calls against the reference: the
        numbers of answers that differ (reward sums compared exactly,
        episode counts exactly)."""
        ctx, w = self.ctx, self.ctx.workload
        last = self.calls - 1
        drawn = int(torch.randint(0, self.calls, (1,), generator=self.gen))
        calls = sorted({drawn, last})
        bad, work = 0, None
        for c in calls:
            rew_p, ep_p = (x.cpu() for x in self.kept[c])
            seed = ctx.seed + c
            if w["engine"] == "checkers":
                rew_r, ep_r = rr.checkers(rr.checkers_spec(ctx.config, w),
                                          self.steps, seed, self.idx)
            else:
                rew_r, ep_r, got = rr.roadway(
                    rr.roadway_config(ctx.config, w), self.steps, seed,
                    self.idx)
                work = {k: (work or {}).get(k, 0) + v for k, v in got.items()}
            bad += int(((rew_p != rew_r) | (ep_p != ep_r)).sum())
        if self.trace is not None:
            self._counts(calls, work)
        return [("answers_differing", bad, w["limits"]["answers_differing"])]

    def _counts(self, calls, work):
        """The kernel's work per call for the roofline: B2's is fixed;
        B4's data-dependent terms are the reference's counts over the
        sample, scaled to the batch, and its resets the kernel's own
        episode counts of the traced calls."""
        b, t = self.batch, self.steps
        c = self.trace.counts
        if work is None:
            c["ops_per_call"] = ro.checkers_ops(b, t)
            c["mufu_per_call"] = 0
        else:
            scale = b / (len(self.idx) * len(calls))
            per = {k: v * scale for k, v in work.items()}
            c["ops_per_call"] = ro.roadway_ops(
                b, t, per["live_car"], per["live_pair"], per["ttc_candidate"],
                per["rejected_draw"], per["goal_reward"],
                self.trace.counters["resets_per_call"])
            c["mufu_per_call"] = ro.roadway_mufu(per["ttc_candidate"],
                                                 per["goal_reward"])
        c["bytes_per_call"] = ro.output_bytes(b)
