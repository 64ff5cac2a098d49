"""The model FLOPs of a training cell: one update and one action of one
seed, counted from the nets' shapes.

The frozen copy of the port's algorithm (``reference/port``) runs one
update and one ``act`` on the ``meta`` device, which has shapes and no
values, under ``torch.utils.flop_counter.FlopCounterMode``: every matrix
product and convolution of the forward and backward passes is counted
at 2 x its multiply-adds, nothing is computed, and nothing is counted
twice (the update recomputes nothing).  Elementwise work is not
counted, as model FLOPs leave it out.  Per seed: a sweep of S seeds
does S times the work."""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import train as rt
from benchmark.reference.port.tree import tree_map


def _meta_like(x, lead):
    return torch.zeros(tuple(lead) + tuple(x.shape), dtype=x.dtype,
                       device="meta")


def _example(config):
    """One transition's leaves (shapes and dtypes) of the configuration's
    replay, from a two-instance sweep on the CPU."""
    small = json.loads(json.dumps(config))
    small["master"]["n_envs"] = 2
    sweep = rt.Sweep(small, 1, rt.draw_source(0, "cpu"), "cpu")
    return sweep._example()


@functools.lru_cache(maxsize=None)
def _counts(config_json: str, batch: int):
    config = json.loads(config_json)
    example = _example(config)
    _, alg, _, _ = rt.build(config, "meta")
    ts = alg.empty_state()
    n, a = alg.n_agents, alg.n_actions
    batch_t = tree_map(lambda x: _meta_like(x, (batch,)), example)
    gumbel = torch.zeros((batch, n, a), device="meta")
    with FlopCounterMode(display=False) as upd:
        alg.update(ts, batch_t, 0.1, gumbel)
    obs = tree_map(lambda x: _meta_like(x, (1,)), example["obs"])
    a_prev = torch.zeros((1, n), dtype=torch.int64, device="meta")
    goals = torch.zeros((1,) + tuple(example["goals"].shape),
                        device="meta")
    with FlopCounterMode(display=False) as act:
        alg.act(ts, obs, goals, a_prev, 0.1,
                torch.zeros((1, n, a), device="meta"))
    return upd.get_total_flops(), act.get_total_flops()


def update_flops(config, batch: int) -> int:
    """FLOPs of one seed's update on a minibatch of ``batch`` rows."""
    return _counts(json.dumps(config, sort_keys=True), batch)[0]


def act_flops(config) -> int:
    """FLOPs of one seed's ``act`` for one instance (all its agents)."""
    return _counts(json.dumps(config, sort_keys=True), 1)[1]
