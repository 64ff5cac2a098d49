"""Window driver ``train_sweep``: S seeds of CM3 trained in lockstep
through the port's ``train.multiseed.train_vmapped_seeds``, the program
built by ``train.runner.build`` from the configuration's master and
``alg.for_seeds(S)``, on-policy where the driver that ``runner.build``
returns is the ``OnPolicyDriver`` (particle), off-policy otherwise.

Set-up: the build, the weights made on the card from ``--seed``
(``reference/weights.py``) and loaded into the program's empty seed
stack (``resume`` with every seed at episode 0, which trains as a fresh
start), the random fill until the slowest seed has ``pretrain_episodes``
episodes, and the training chunks up to the first period row: every
shape of the window (fill, training chunk or on-policy rollout chunk and
burst, evaluation) has run.  The window runs whole periods of the
lockstep loop, evaluations and its per-chunk sync included, from that
row to the first row at or after ``--seconds``.
``train_env_steps_per_s`` counts the training-rollout env steps of all
seeds in the window, S x E x ``steps_per_train`` per chunk, over the
window's host seconds; counting adds no host sync.  Off-policy the
chunks are read from the update count of the state the rows hand over
(``updates_per_chunk`` updates a chunk).  On-policy, where a burst of
``epochs`` updates follows every few rollout chunks, a host counter
around ``OnPolicyDriver._rollout_chunk`` counts the chunks that start
inside the window.

With ``--trace 1`` the first ``traced_chunks`` chunks after the window
(the cell's file; a third of a period) run under the profiler, with the
benchmark's spans around the driver's chunk (``OffPolicyDriver._chunk``,
on-policy ``OnPolicyDriver._rollout_chunk``), env step (``_step_once``)
and the algorithm's update, and the run ends with them; a whole
period's trace runs to gigabytes and minutes of the profiler's own
work.  On-policy the traced stretch is whole cycles: it starts with the
first rollout chunk after a burst and ends with the first burst after
its ``traced_chunks``-th chunk, so it holds every burst that its chunks
bring about and a per-chunk reading does not depend on where in the
cycle the window closed.  The evaluations are timed on the host clock
over the window instead (``eval_share``).  ``train_mfu`` counts the
FLOPs of the updates run in the window (their count read from the
state's step, on-policy the bursts' ``epochs`` each), of each chunk's
actions and of each evaluation's.

Correctness: the first ``n_checked`` updates, which set-up runs through
the same call and draw source as the window, are recomputed by the
plain reference (``reference/train.py``) once the window has closed and
the program's state is freed, and compared (``reference/compare.py``)."""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from benchmark import harness
from benchmark.counts import flops
from benchmark.counts.rollout_ops import FP32_FLOPS_PER_S
from benchmark.reference import compare as cmp
from benchmark.reference import train as rt
from benchmark.reference import weights as wts

SPAN_NAMES = ("chunk", "env_step", "update")


class WindowClosed(Exception):
    """Raised from the period rows' callback to end the run."""


def _host(x):
    """A copy of ``x`` on the CPU (the update writes its buffers in
    place)."""
    return x.detach().to("cpu", copy=True)


class Capture:
    """Stands in for ``alg.update``: the first ``n`` updates' losses, the
    first minibatch, the Adam first moments after the first update and
    the parameters after the n-th, copied as they pass; later updates
    pass straight through.  With ``stop`` the n-th update ends the run
    (``WindowClosed``)."""

    def __init__(self, alg, n: int, stop: bool = False):
        self.inner, self.n, self.k, self.stop = alg.update, n, 0, stop
        self.names = alg.net_names()
        self.losses, self.mu1, self.params = [], {}, {}
        alg.update = self

    def __call__(self, ts, batch, *args, **kwargs):
        if self.k == 0:
            self.batch1 = rt.flat_leaves(batch)
        ts, metrics = self.inner(ts, batch, *args, **kwargs)
        if self.k < self.n:
            self.k += 1
            self.losses.append({k: _host(v) for k, v in metrics.items()
                                if k != "grads"})
            if self.k == 1:
                self.mu1 = {n: _host(getattr(ts, "opt_" + n).mu)
                            for n in self.names}
            if self.k == self.n:
                self.params = {key: _host(getattr(ts, key).flat)
                               for n in self.names
                               for key in (n, n + "_tgt")}
                if self.stop:
                    raise WindowClosed
        return ts, metrics


class Window:
    """The period rows' callback: opens the window at the first row,
    closes it at the first row at or after ``seconds``, and, tracing,
    profiles the next ``traced_chunks`` chunks; on-policy, whole cycles
    of rollout chunks and the burst that ends each, from the first chunk
    after a burst to the first burst after the ``traced_chunks``-th
    chunk, so a per-chunk reading does not hang on where the stretch
    cut the cycle.  ``install`` puts one wrapper around the driver's
    chunk (``_chunk``, on-policy ``_rollout_chunk``), which counts the
    chunks that start inside the window (``window_chunks``; no sync)
    and the traced ones, and, on-policy, one around the burst
    (``_train_burst``); tracing, it also times the driver's evaluations
    inside the window on the host clock."""

    def __init__(self, seconds, trace, out_dir, device, driver_cls,
                 onpolicy, traced_chunks=7):
        self.seconds, self.trace, self.out_dir = seconds, trace, out_dir
        self.device, self.driver_cls = device, driver_cls
        self.onpolicy, self.traced_chunks = onpolicy, traced_chunks
        self.targets = [(driver_cls, "_step_once", "env_step")]
        self.spanned = self.armed = self.after_burst = False
        self.t0 = self.t1 = None
        self.rows = 0
        self.steps = []
        self.traced = None
        self.eval_s = 0.0
        self.chunks = self.updates = 0
        self.window_chunks = 0
        self._undo = []
        self._installed = []

    def _patch(self, attr, make):
        """``driver_cls.attr`` replaced by ``make(inner)`` until
        ``close``."""
        self._installed.append(harness.replace(self.driver_cls, attr,
                                               make))

    def install(self):
        self._patch("_rollout_chunk" if self.onpolicy else "_chunk",
                    self._chunk)
        if self.onpolicy:
            self._patch("_train_burst", self._burst)
        if self.trace:
            self._patch("evaluate", self._timed)

    def _chunk(self, inner):
        def chunk(*args, **kwargs):
            if self.armed and self.after_burst:
                self.armed = False
                self._start_trace()
            self.after_burst = False
            if not self.spanned:
                if self.t0 is not None and self.t1 is None:
                    self.window_chunks += 1
                return inner(*args, **kwargs)
            with torch.profiler.record_function("chunk"):
                out = inner(*args, **kwargs)
            self.chunks += 1
            if not self.onpolicy and self.chunks == self.traced_chunks:
                self._end()
            return out
        return chunk

    def _burst(self, inner):
        def burst(*args, **kwargs):
            out = inner(*args, **kwargs)
            self.after_burst = True
            if self.spanned and self.chunks >= self.traced_chunks:
                self._end()
            return out
        return burst

    def _timed(self, evaluate):
        """Tracing: time each evaluation inside the window."""
        def timed(*args, **kwargs):
            t = time.perf_counter()
            try:
                return evaluate(*args, **kwargs)
            finally:
                if self.t0 is not None and self.t1 is None:
                    self.eval_s += time.perf_counter() - t
        return timed

    def _end(self):
        """The last traced chunk or burst has run: stop the profiler and
        end the run."""
        harness.synchronize(self.device)
        self._stop_trace()
        raise WindowClosed

    def __call__(self, row):
        now = time.perf_counter()
        step = int(row["_ts"].step)
        if self.t0 is None:
            self.t0, self.steps = now, [step]
            return
        if self.t1 is None:
            self.rows += 1
            if now - self.t0 < self.seconds:
                return
            self.t1 = now
            self.steps.append(step)
            if not self.trace:
                raise WindowClosed
            if self.onpolicy:
                self.armed = True   # the trace starts with a cycle
            else:
                self._start_trace()
            return
        # a row inside the traced chunks (a period shorter than they
        # are) changes nothing: the chunk count ends the run

    def wrap_update(self, update):
        """The algorithm's update in the span "update" while tracing."""
        def spanned(*args, **kwargs):
            if not self.spanned:
                return update(*args, **kwargs)
            self.updates += 1
            with torch.profiler.record_function("update"):
                return update(*args, **kwargs)
        return spanned

    def _start_trace(self):
        self._undo = [harness.wrap(*t) for t in self.targets]
        self.spanned = True
        self._prof = harness.profile(self.out_dir, self.device)
        self._prof.__enter__()
        self._span = torch.profiler.record_function("window")
        self._span.__enter__()

    def _stop_trace(self):
        t0 = time.perf_counter()
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.spanned = False
        for u in reversed(self._undo):
            u()
        t1 = time.perf_counter()
        path = os.path.join(self.out_dir, "trace.json")
        self._prof.export_chrome_trace(path)
        self.traced = path
        print(f"benchmark: profiler stop {t1 - t0:.3f} s, trace written "
              f"{time.perf_counter() - t1:.3f} s, "
              f"{os.path.getsize(path)} bytes", file=sys.stderr)

    def close(self):
        """Undo the wrappers and stop the profiler if a run ended inside
        the traced chunks."""
        if self.traced is None and self.spanned:
            self._span.__exit__(None, None, None)
            self._prof.__exit__(None, None, None)
            self.spanned = False
            for u in reversed(self._undo):
                u()
        for restore in reversed(self._installed):
            restore()
        self._installed = []


def build_program(config, n_seeds, seed, device):
    """(alg for S seeds, hooks, train config, state, initial weights,
    the one-seed driver): the program built by the port's runner from
    the configuration's master, its state the benchmark's weights."""
    from cm3_tpu_torch.train import runner

    driver, alg, hooks, cfg = runner.build(dict(config["master"]),
                                           device=device)
    alg = alg.for_seeds(n_seeds)
    ref_alg = rt.build(config, "cpu")[1]
    weights = wts.make_weights(ref_alg, n_seeds, seed, device)
    ts = alg.empty_state()
    with torch.no_grad():
        for name, w in weights.items():
            for key in (name, name + "_tgt"):
                flat = getattr(ts, key).flat
                if tuple(flat.shape) != tuple(w.shape):
                    raise ValueError(f"{key}: the program's layout "
                                     f"{tuple(flat.shape)} is not the "
                                     f"reference's {tuple(w.shape)}")
                flat.copy_(w)
    return alg, hooks, cfg, ts, weights, driver


class Run:
    """One run of a ``train_sweep`` cell; ``metrics``, ``trace``,
    ``attempted`` and ``failed`` once ``run`` has returned, then
    ``check()``."""

    def __init__(self, ctx):
        self.ctx = ctx
        w = ctx.workload
        self.n_seeds = w["seeds"]
        self.n_checked = w.get("checked_updates", 3)

    def _build(self):
        """Build the program (``build_program``; ``_train`` lets it go)
        and tell whether its driver trains on-policy."""
        from cm3_tpu_torch.train.onpolicy import OnPolicyDriver

        self.program = build_program(self.ctx.config, self.n_seeds,
                                     self.ctx.seed, self.ctx.device)
        self.weights, driver = self.program[4:]
        self.driver_cls = type(driver)
        self.onpolicy = isinstance(driver, OnPolicyDriver)

    def _train(self, log_fn=None, stop=False, update=None):
        """Train the built program through the lockstep loop until
        ``log_fn`` or (``stop``) the last checked update ends it; returns
        its train config.  ``update`` wraps the algorithm's update (the
        control's planted faults)."""
        from cm3_tpu_torch.train import multiseed

        ctx, s = self.ctx, self.n_seeds
        alg, hooks, cfg, ts = self.program[:4]
        if update is not None:
            alg.update = update(alg.update)
        self.capture = Capture(alg, self.n_checked, stop)
        try:
            multiseed.train_vmapped_seeds(
                hooks, alg, cfg, s, ctx.seed, n_episodes=10 ** 12,
                log_fn=log_fn, onpolicy=self.onpolicy,
                resume=(ts, np.zeros(s, np.int64)),
                draws=rt.draw_source(ctx.seed, ctx.device))
        except WindowClosed:
            pass
        self.program = None
        if self.capture.k < self.n_checked:
            raise RuntimeError(f"set-up ran {self.capture.k} updates, fewer "
                               f"than the {self.n_checked} it checks")
        return cfg

    def checked_only(self, update=None):
        """Set-up up to the last checked update, and no window."""
        self._build()
        self._train(stop=True, update=update)
        return self

    def run(self):
        ctx, s = self.ctx, self.n_seeds
        self._build()
        window = Window(ctx.seconds, ctx.trace, ctx.out_dir, ctx.device,
                        self.driver_cls, self.onpolicy,
                        ctx.workload.get("traced_chunks", 7))
        window.install()
        try:
            cfg = self._train(log_fn=window, update=window.wrap_update)
        finally:
            window.close()
        per_chunk = s * cfg.n_envs * cfg.steps_per_train
        if self.onpolicy:
            chunks = window.window_chunks
            updates = window.steps[1] - window.steps[0]
        else:
            n_upd = cfg.updates_per_chunk or cfg.n_envs
            chunks = (window.steps[1] - window.steps[0]) // n_upd
            updates = chunks * n_upd
        seconds = window.t1 - window.t0
        self.attempted, self.failed = chunks, 0
        self.setup_s = window.t0 - ctx.t_process
        self.metrics = {"train_env_steps_per_s": chunks * per_chunk / seconds,
                        "setup_s": self.setup_s}
        self.trace = None
        if window.traced:
            upd_f = s * flops.update_flops(ctx.config, cfg.batch_size)
            act_f = s * flops.act_flops(ctx.config)
            window_flops = (updates * upd_f
                            + chunks * cfg.steps_per_train * cfg.n_envs
                            * act_f
                            + window.rows * cfg.N_eval * cfg.max_steps
                            * act_f)
            t_red = time.perf_counter()
            ops, spans, win = harness.reduce_trace(window.traced, SPAN_NAMES,
                                                   "window")
            print(f"benchmark: trace read {time.perf_counter() - t_red:.3f}"
                  " s", file=sys.stderr)
            os.remove(window.traced)
            self.trace = harness.Trace(
                ops, spans, win,
                counters={"traced_updates": window.updates},
                counts={"window_flops": window_flops,
                        "window_s": seconds, "eval_s": window.eval_s,
                        "peak_flops_per_s": FP32_FLOPS_PER_S})
        return self

    def gaps(self, tf32=False, cudnn=True, again=False):
        """The comparison's numbers and detail (``reference/compare.py``)
        of the program's checked updates against the reference's, or
        (``tf32``) of the reference computed with TF32 against it: the
        control; or (``cudnn`` off) of the reference with PyTorch's own
        convolutions against it; or (``again``) of a second run of the
        reference against the first (cuDNN's weight gradient adds in a
        varying order).  The first float32 reference is kept for the
        next call."""
        if torch.device(self.ctx.device).type == "cuda":
            torch.cuda.empty_cache()
        run_ref = lambda tf, cd=True: rt.run_reference(
            self.ctx.config, self.n_seeds, self.ctx.seed, self.weights,
            self.ctx.device, n_updates=self.n_checked, tf32=tf, cudnn=cd)
        ref = getattr(self, "last_reference", None) or run_ref(False)
        self.last_reference = ref
        if tf32 or not cudnn or again:
            low = run_ref(tf32, cudnn)
            got = {"losses": low["losses"], "params": low["params"],
                   "mu1": {n: g * (1.0 - cmp.B1)
                           for n, g in low["grads"].items()}}
        else:
            cap = self.capture
            got = {"losses": cap.losses, "mu1": cap.mu1,
                   "params": cap.params}
        layout = wts.layout(rt.build(self.ctx.config, "cpu")[1])
        initial = {k: v.cpu() for k, v in self.weights.items()}
        self.last_inputs = (got, ref, initial, layout)
        return cmp.compare(got, ref, initial, layout)

    def check(self):
        """[(name, value, limit)] of the comparison with the reference."""
        got = self.gaps()
        limits = self.ctx.workload["limits"]
        return [(k, got[k], limits[k]) for k in (
            "loss_gap", "later_loss_gap_q90", "grad_gap_q90",
            "change_gap_q90")]
