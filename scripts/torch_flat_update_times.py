#!/usr/bin/env python3
"""Time the port's flat-update kernels, B1 (``adam_polyak``) and B3
(``polyak_update``), at the main path's sizes on one CUDA card, with
``chip_smoke.py``'s harness: device time per launch in CUDA graphs,
after a PyTorch kernel (the time a launch adds to it), warm (the same
buffers every launch) and cold (rotating over 128 MB of buffer sets, so
that every launch misses the L2), each in turns with the others.

    python3 scripts/torch_flat_update_times.py
    PYTHONPATH=DIR python3 scripts/torch_flat_update_times.py

It times the wrappers of the ``cm3_tpu_torch`` package that Python
finds first: this checkout's, or the one in ``DIR``.  B1 runs over the
actor (149,645 floats), over both critics (144,741 + 144,709; one
launch where the package has ``adam_polyak_many``, else two) and as one
CM3 update's tail (two or three launches); B3 over the actor.  Running
it over two checkouts in turns (parent, change, change, parent) in one
machine session compares them on one card.  Prints one JSON line.
Needs a CUDA device.
"""

import importlib.util
import json
import os
import statistics
import sys

sys.dont_write_bytecode = True
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(ROOT)     # after PYTHONPATH, so that DIR's package wins


def load_smoke():
    """This checkout's ``chip_smoke.py`` (its harness), whatever
    checkout ``cm3_tpu_torch`` comes from."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def summary(ms):
    return {"median_us": statistics.median(ms) * 1e3,
            "min_us": min(ms) * 1e3, "max_us": max(ms) * 1e3}


def times(cs, dev):
    import torch
    from cm3_tpu_torch.ops import fused_opt, polyak

    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    many = getattr(fused_opt, "adam_polyak_many", None)

    def adam(nets):
        """One launch over ``nets`` where the package can, else one
        each."""
        items = [(st, p, t, g, cs.LR) for st, p, t, g in nets]
        if many is not None:
            return lambda: many(items, cs.TAU)
        return lambda: [fused_opt.adam_polyak(*item, cs.TAU)
                        for item in items]

    sizes = cs.MAIN_SIZES
    nets = {"adam_polyak actor": ["actor"],
            "adam_polyak critics": ["Q_global", "Q_credit"]}

    def update():
        actor = adam([cs.adam_net(dev, gen, sizes["actor"])])
        critics = adam([cs.adam_net(dev, gen, sizes[k])
                        for k in nets["adam_polyak critics"]])
        return lambda: (actor(), critics())

    def polyak_call():
        t, m = (torch.randn(sizes["actor"], device=dev, generator=gen)
                for _ in range(2))
        return lambda: polyak.polyak_update(t, m, cs.TAU)

    makers = {k: (lambda ks=ks: adam([cs.adam_net(dev, gen, sizes[n])
                                      for n in ks]))
              for k, ks in nets.items()}
    makers["adam_polyak per update"] = update
    makers["polyak actor"] = polyak_call
    set_bytes = {k: cs.BYTES_PER_ELEM * sum(sizes[n] for n in ks)
                 for k, ks in nets.items()}
    set_bytes["adam_polyak per update"] = (cs.BYTES_PER_ELEM
                                           * sum(sizes.values()))
    set_bytes["polyak actor"] = cs.POLYAK_BYTES_PER_ELEM * sizes["actor"]
    names = list(makers)
    foreign, after = cs.after_pytorch(dev)
    got = cs.graph_turns(foreign, *[after(makers[k]()) for k in names])
    alone, pairs = got[0], got[1:]
    warm = cs.graph_turns(*[makers[k]() for k in names])
    cold = cs.graph_turns(*[cs.rotation(makers[k], set_bytes[k])
                            for k in names])
    return {k: {"after_pytorch_us": cs.after_ms(a, alone) * 1e3,
                "warm": summary(w), "cold": summary(c),
                "bound_us": set_bytes[k] / cs.HBM_BPS * 1e6}
            for k, a, w, c in zip(names, pairs, warm, cold)}


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_flat_update_times: no CUDA device")
    import cm3_tpu_torch
    cs = load_smoke()
    dev = torch.device("cuda", 0)
    card = cs.smi_line()
    tree = os.path.dirname(os.path.dirname(os.path.abspath(
        cm3_tpu_torch.__file__)))
    print(f"card: {card}; torch {torch.__version__}; package from {tree}")
    print(json.dumps({"card": card, "tree": tree, "times": times(cs, dev)}))


if __name__ == "__main__":
    main()
