"""The comparison's readings on the card, at a cell's own size: the
program's gaps over many seeds (the lower reading of each limit), the
control's (the upper reading), and the planted faults'.  The benchmark's
own runs never run this.

    python benchmark/control.py --workload <cell> --seeds 1,2,3 \\
        [--fault none|half_batch|frozen|native_conv|ref_again|answer] \\
        [--control-seeds 1] [--dump DIR]

Training cells (``train_sweep``): for each seed, the set-up up to the
checked updates, then the reference; prints the program's numbers
(``program``), the reference computed with TF32 against it
(``control``), and with ``--fault`` the program with a fault planted
under the timed path: ``half_batch`` (every update on the first half of
its minibatch, the mean over the rest) or ``frozen`` (every update
returns the state unchanged), or ``native_conv`` (no fault: the
reference with PyTorch's own convolutions against the one with cuDNN's,
how far two float32 references lie apart), or ``ref_again`` (no fault: a
second run of the reference against the first); several, comma
separated, on the seeds of ``--control-seeds``.  Rollout cells
(``rollout``): for each seed, one call at the cell's size and the
reference over the sample;
prints the answers that differ from the program's (``program``), from
the reference accumulated in bfloat16 (``control``), and with ``--fault
answer`` from the program's answers each one ulp off.

One JSON line per seed and reading on standard output."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def half_batch(update):
    """The update on the first half of the minibatch's rows."""
    from benchmark.reference.port.tree import tree_map

    def faulty(ts, batch, epsilon, gumbel, *args, **kwargs):
        half = gumbel.shape[-3] // 2
        return update(ts, tree_map(lambda x: x[:, :half], batch), epsilon,
                      gumbel[:, :half], *args, **kwargs)
    return faulty


def frozen(update):
    """An update that leaves the networks, their targets and the Adam
    moments as they were (its losses computed and returned)."""
    import dataclasses

    import torch

    def faulty(ts, *args, **kwargs):
        saved = []
        for f in dataclasses.fields(ts):
            v = getattr(ts, f.name)
            for buf in ((v.flat,) if hasattr(v, "flat") else
                        (v.mu, v.nu) if hasattr(v, "mu") else ()):
                saved.append((buf, buf.clone()))
        ts, metrics = update(ts, *args, **kwargs)
        with torch.no_grad():
            for buf, old in saved:
                buf.copy_(old)
        return ts, metrics
    return faulty


def batch_rows_differing(prog, ref):
    """[S] rows of the first minibatch in which any flat tensor leaf of
    the program's differs from the reference's (the data path, apart
    from the arithmetic of the update)."""
    import torch

    rows = None
    for k, p in prog.items():
        r = ref[k]
        d = (p != r).reshape(p.shape[0], p.shape[1], -1).any(-1)
        rows = d if rows is None else rows | d
    return rows.sum(1).tolist()


def context(cell, seed, device="cuda"):
    from benchmark import harness
    from benchmark.run import merged_config

    bench, entry, workload, conf = harness.cell(cell)
    return types.SimpleNamespace(
        workload=workload, config=merged_config(conf, workload), seed=seed,
        seconds=0.0, trace=False, device=device,
        t_process=time.perf_counter(),
        out_dir=os.path.join(ROOT, "benchmark_out", cell))


def per_seed(got, ref, initial, layout):
    """The comparison's inputs reduced per seed of the sweep, for a look
    at where a gap comes from: each loss {name@k: [2, S]} (program,
    reference), each leaf's gradient and change norms {"g.<net>",
    "d.<net or net_tgt>": [2, S, L]}, and per network [S] the gradient
    elements whose sign differs from the reference's ("flips.<net>"),
    which Adam's first step moves by twice the learning rate."""
    import torch

    from benchmark.reference import compare as cmp

    out = {}
    for k, (lp, lr) in enumerate(zip(got["losses"], ref["losses"])):
        for name, r in lr.items():
            out[f"{name}@{k + 1}"] = torch.stack(
                [lp[name].double(), r.double()])
    for n, leaves in layout.items():
        gp, gr = got["mu1"][n], ref["grads"][n]
        out["g." + n] = torch.stack([cmp.leaf_norms(gp, leaves)
                                     / (1.0 - cmp.B1),
                                     cmp.leaf_norms(gr, leaves)])
        out["flips." + n] = ((torch.sign(gp) != torch.sign(gr))
                             & (gr != 0)).sum(1)
        for key in (n, n + "_tgt"):
            out["d." + key] = torch.stack([
                cmp.leaf_norms(got["params"][key] - initial[n], leaves),
                cmp.leaf_norms(ref["params"][key] - initial[n], leaves)])
    return out


def train_readings(ctx, faults=(), control=True, dump=None):
    """{reading: {number: value, "detail": ...}} of one seed: the
    program's, the control's (with ``control``) and each of ``faults``';
    ``dump(reading, per_seed)`` gets each reading's per-seed
    reduction."""
    from benchmark import harness

    driver = harness.load_module("drivers", ctx.workload["driver"])
    run = driver.Run(ctx).checked_only()

    def read(name, **kw):
        got = run.gaps(**kw)
        if dump is not None:
            dump(name, per_seed(*run.last_inputs))
        return got

    out = {"program": read("program")}
    if control:
        out["control"] = read("control", tf32=True)
    out["program"]["batch_rows_differing"] = sum(batch_rows_differing(
        run.capture.batch1, run.last_reference["batch1"]))
    for f in faults:
        if f == "native_conv":
            out[f] = read(f, cudnn=False)
        elif f == "ref_again":
            out[f] = read(f, again=True)
        else:
            ref = run.last_reference
            run = driver.Run(ctx).checked_only(
                update={"half_batch": half_batch, "frozen": frozen}[f])
            run.last_reference = ref        # the same seed's reference
            out[f] = read(f)
    return out


def rollout_readings(ctx, fault=None):
    import torch

    from benchmark import harness
    from benchmark.reference import rollout as rr

    driver = harness.load_module("drivers", ctx.workload["driver"])
    run = driver.Run(ctx)
    fn, game = driver._program(ctx)
    rew, ep = run._call(fn, game, 0)
    rew_p, ep_p = rew[run.idx.to(rew.device)].cpu(), \
        ep[run.idx.to(ep.device)].cpu()
    w = ctx.workload

    def ref(dtype):
        if w["engine"] == "checkers":
            return rr.checkers(rr.checkers_spec(ctx.config, w), run.steps,
                               ctx.seed, run.idx, dtype)
        return rr.roadway(rr.roadway_config(ctx.config, w), run.steps,
                          ctx.seed, run.idx, dtype)[:2]

    def differ(r, e, rr_, er):
        return int(((r != rr_) | (e != er)).sum())

    r32, e32 = ref(torch.float32)
    r16, e16 = ref(torch.bfloat16)
    out = {"program": {"answers_differing": differ(rew_p, ep_p, r32, e32)},
           "control": {"answers_differing": differ(r16, e16, r32, e32)}}
    if fault == "answer":
        off = torch.nextafter(rew_p, torch.full_like(rew_p, float("inf")))
        out["answer"] = {"answers_differing": differ(off, ep_p, r32, e32)}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--fault", default="none")
    p.add_argument("--control-seeds", default=None,
                   help="the seeds of --seeds that also read the control "
                        "and the fault (default: all)")
    p.add_argument("--no-control", action="store_true",
                   help="read no control, only the program and the fault")
    p.add_argument("--dump", default=None,
                   help="a directory for each training reading's per-seed "
                        "reduction (<workload>.<seed>.<reading>.pt)")
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 1
    faults = [f for f in args.fault.split(",") if f != "none"]
    seeds = [int(s) for s in args.seeds.split(",")]
    with_control = set(seeds if args.control_seeds is None else
                       (int(s) for s in args.control_seeds.split(",")))
    if args.dump:
        os.makedirs(args.dump, exist_ok=True)
    for seed in seeds:
        ctx = context(args.workload, seed)
        t0 = time.perf_counter()
        if ctx.workload["driver"] == "train_sweep":
            dump = None if not args.dump else (
                lambda reading, d, seed=seed: torch.save(d, os.path.join(
                    args.dump, f"{args.workload}.{seed}.{reading}.pt")))
            got = train_readings(ctx, faults if seed in with_control else (),
                                 seed in with_control and not args.no_control,
                                 dump)
        else:
            got = rollout_readings(ctx, faults[0] if faults else None)
        for reading, numbers in got.items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "reading": reading, **numbers,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
