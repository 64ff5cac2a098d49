"""The training cells' plain reference: the first updates of a seed sweep,
recomputed from the seed.

The benchmark makes every input of a training cell from ``--seed``: the
weights (``weights.py``) and one draw source (``draws``), and hands the
same to the program and to this reference.  The reference builds its
own engines, hooks, replay and algorithm from the frozen copy in
``port/``, one seed's networks at a time in plain flattened modules
(the program runs all seeds in one seed stack), and replays the lockstep
schedule of ``train_vmapped_seeds`` up to the program's first
``n_updates`` updates: the random fill, ``steps_per_train`` random
steps at a time until the slowest seed has ``pretrain_episodes``
episodes, then the configuration's schedule (``onpolicy``: the port's
runner trains particle on-policy, Checkers and roadway off-policy):

* off-policy (``multiseed.py:203-209``): training chunks, each its env
  steps with each seed's epsilon-greedy policy (each seed's epsilon
  from its own completed episodes) and then ``updates_per_chunk`` (or
  ``n_envs``) updates;
* on-policy (``multiseed.py:189-200``): rollout chunks of
  ``steps_per_train`` steps at one epsilon for all seeds, from
  ``epsilon_start``; after a chunk, once the slowest seed has
  ``episodes_per_train`` more episodes than at the last burst (0 at the
  start), a burst of ``epochs`` updates, then the ring discarded
  (cursor and fill to 0) and epsilon decayed once.  The first burst
  follows the first policy chunk after the fill, on a ring that still
  holds the fill's rows.

Engines, hooks and replay run over all S x E instances at once, as the
program's do; their arithmetic is elementwise per instance, so the
batch does not change a result.

It returns what the comparison reads (``compare.py``): each update's
losses, each network's first gradient, and each network's and target's
parameters after the last update."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.port import buffer as replay
from benchmark.reference.port import config as cfgmod
from benchmark.reference.port import nets, prng
from benchmark.reference.port.checkers import Checkers
from benchmark.reference.port.cm3 import CM3
from benchmark.reference.port.experiments import flat_call, make_hooks
from benchmark.reference.port.particle import Particle
from benchmark.reference.port.roadway import Roadway
from benchmark.reference.port.tree import tree_map


def draw_source(seed: int, device):
    """The one draw source of a training run: program and reference each
    make their own from the seed, and ask it for the same draws in the
    same order."""
    return prng.GeneratorDraws(prng.generator(
        prng.for_purpose(prng.root_key(seed), prng.ROLLOUT), device))


def nn_config(config) -> cfgmod.NNConfig:
    nn = dict(config["master"].get("nn", {}))
    nn.update(config.get("stage_file", {}).get("nn", {}))
    known = {f.name for f in dataclasses.fields(cfgmod.NNConfig)}
    return cfgmod.NNConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                              for k, v in nn.items() if k in known})


def build_env(config, device):
    """The configuration's engine; its ``stage_file`` holds the file the
    port's runner reads: ``{experiment}_stage{stage}.json``, or for
    particle ``particle_`` + ``master["particle_config"]`` (the contract
    test holds the two equal)."""
    master, sf = config["master"], config["stage_file"]
    if master["experiment"] == "particle":
        return Particle(cfgmod.ParticleEnvConfig(
            n_agents=sf["n_agents"], agents_x=tuple(sf["agents_x"]),
            agents_y=tuple(sf["agents_y"]),
            landmarks_x=tuple(sf["landmarks_x"]),
            landmarks_y=tuple(sf["landmarks_y"]),
            initial_std=sf["initial_std"],
            prob_random=master["prob_random"],
            max_steps=master["max_steps"]), device=device)
    if master["experiment"] == "checkers":
        init = sf["init"]
        return Checkers(cfgmod.CheckersEnvConfig(
            n_rows=init["n_rows"], n_columns=init["n_columns"],
            n_obs=init["n_obs"], agents_r=tuple(init["agents_r"]),
            agents_c=tuple(init["agents_c"]), n_agents=sf["n_agents"],
            max_steps=master["max_steps"]), device=device)
    if master["experiment"] == "roadway":
        return Roadway(cfgmod.RoadwayEnvConfig(
            n_agents=sf["n_agents"], goal_lane=tuple(sf["goal_lane"]),
            goal_pos=tuple(sf["goal_pos"]), speed=tuple(sf["speed"]),
            lane=tuple(sf["lane"]), init_position=tuple(sf["init_position"]),
            depart_mean=tuple(sf["depart_mean"]),
            depart_stdev=sf["depart_stdev"],
            total_length=sf["total_length"], total_width=sf["total_width"],
            save_threshold=sf["save_threshold"],
            prob_random=master["prob_random"]), device=device)
    raise ValueError(master["experiment"])


def build(config, device):
    """(env, CM3, hooks, train config) of a configuration file's
    ``master`` and ``stage_file``, as the port's runner builds CM3."""
    master = config["master"]
    if master.get("alg_name", "cm3") != "cm3":
        raise ValueError("the reference trains CM3 only")
    env = build_env(config, device)
    alg_cfg = cfgmod.AlgConfig(
        alg_name="cm3", stage=master["stage"],
        n_agents=env.spec()["n_agents"],
        use_Q_credit=bool(master.get("use_Q_credit", 1)),
        use_V=bool(master.get("use_V", 0)),
        use_Q=bool(master.get("use_Q", 0)),
        IAC=bool(master.get("IAC", 0)), alpha=master.get("alpha", 0.7),
        lr_Q=master.get("lr_Q", 1e-3), lr_V=master.get("lr_V", 1e-3),
        lr_actor=master.get("lr_actor", 1e-4),
        grad_clip=master.get("grad_clip", 0.0),
        init_scheme=master.get("init_scheme", "ref"),
        fused_opt=bool(master.get("fused_opt", 0)))
    alg = CM3(master["experiment"], env.spec(), alg_cfg, nn_config(config),
              device=device)
    known = {f.name for f in dataclasses.fields(cfgmod.TrainConfig)}
    tc = {k: v for k, v in master.items() if k in known}
    tc["buffer_size"] = int(master.get("buffer_size", 2e4))
    train_cfg = cfgmod.TrainConfig(**tc)
    hooks = make_hooks(master["experiment"], env,
                       threshold=train_cfg.threshold)
    return env, alg, hooks, train_cfg


def onpolicy(config) -> bool:
    """Whether the program trains the configuration on-policy: as the
    port's runner decides, particle with CM3, COMA or IAC (the reference
    trains CM3 only)."""
    master = config["master"]
    return (master["experiment"] == "particle"
            and master.get("alg_name", "cm3") in ("cm3", "coma", "iac"))


def epsilons(cfg, episodes):
    """Each seed's epsilon from its completed episodes, float64 as the
    lockstep loop computes it."""
    e = np.maximum(0, episodes - cfg.pretrain_episodes)
    return np.maximum(cfg.epsilon_end, cfg.epsilon_start
                      - e * cfg.epsilon_step)


def _where(done, new, old):
    return torch.where(done.view(done.shape + (1,) * (old.dim()
                                                      - done.dim())),
                       new, old)


class Sweep:
    """The lockstep rollouts of S seeds x E instances with one replay ring
    (or pair of memories) per seed, stepped as the off-policy driver
    steps them on one device (the on-policy driver steps them alike, and
    ``discard`` empties the replay after its bursts)."""

    def __init__(self, config, n_seeds: int, draws, device):
        self.env, self.alg, self.hooks, self.cfg = build(config, device)
        self.onpolicy = onpolicy(config)
        self.device = torch.device(device)
        self.draws = draws
        self.lead = (n_seeds, self.cfg.n_envs)
        env_state, ts, goals = self.hooks.episode_init(self.lead, draws)
        n = self.hooks.n_agents
        zeros = lambda shape, **kw: torch.zeros(shape, device=self.device,
                                                **kw)
        self.env_state, self.obs, self.state = env_state, ts.obs, ts.state
        self.goals = goals
        self.a_prev = zeros(self.lead + (n,), dtype=torch.int64)
        self.ep_ret_local = zeros(self.lead + (n,))
        self.episodes = zeros((n_seeds,), dtype=torch.int64)
        example = self._example()
        if self.cfg.dual_buffer:
            self.buf = replay.init_dual(example, self.cfg.buffer_size,
                                        n_seeds)
            t_max = self.cfg.max_steps
            self.stage = tree_map(
                lambda x: zeros(self.lead + (t_max + 1,) + tuple(x.shape),
                                dtype=x.dtype), example)
            self.stage_t = zeros(self.lead, dtype=torch.int64)
        else:
            self.buf = replay.init(example, self.cfg.buffer_size, n_seeds)

    def _transition(self, actions, ts_next):
        tr = {"obs": self.obs, "state": self.state, "a": actions,
              "a_prev": self.a_prev, "r": ts_next.reward,
              "rl": ts_next.reward_local, "obs_next": ts_next.obs,
              "state_next": ts_next.state, "done": ts_next.done,
              "goals": self.goals}
        if not self.hooks.has_a_prev:
            tr.pop("a_prev")
        return tr

    def _example(self):
        zeros = torch.zeros(self.lead + (self.hooks.n_agents,),
                            dtype=torch.int64, device=self.device)
        ts = flat_call(self.env.step, self.lead, self.env_state, zeros)[1]
        return tree_map(lambda x: x[0, 0], self._transition(zeros, ts))

    def _filter(self, actions):
        if not hasattr(self.env, "check_actions"):
            return actions
        return flat_call(self.env.check_actions, self.lead, self.env_state,
                         actions)

    def _stage_and_flush(self, tr, done, env_state, ep_ret_local):
        t_max = self.cfg.max_steps
        m = self.stage_t.numel()
        at = (torch.arange(m, device=self.device), self.stage_t.reshape(m))
        tree_map(lambda slab, x: slab.view(
            (m, t_max + 1) + slab.shape[3:]).index_put_(
                at, x.reshape((m,) + x.shape[2:])), self.stage, tr)
        stage_len = torch.clamp_max(self.stage_t + 1, t_max)
        valid = done[..., None] & (torch.arange(t_max + 1,
                                                device=self.device)
                                   < stage_len[..., None])
        replay.flush_episodes(self.buf, self.stage, valid,
                              self.hooks.is_bad_episode(env_state,
                                                        ep_ret_local))
        self.stage_t = torch.where(done, 0, stage_len)

    @torch.no_grad()
    def step(self, states=None, epsilon=None):
        """One lockstep env step: random actions, or (``states``, one per
        seed) each seed's policy at ``epsilon`` [S]."""
        shape = self.lead + (self.hooks.n_agents,)
        n_act = self.alg.n_actions
        if states is None:
            actions = self.draws.randint(shape, n_act)
        else:
            gumbel = self.draws.gumbel(shape + (n_act,))
            actions = torch.stack([
                self.alg.act(ts, tree_map(lambda x: x[i], self.obs),
                             self.goals[i], self.a_prev[i], epsilon[i],
                             gumbel[i]) for i, ts in enumerate(states)])
        actions = self._filter(actions)
        env_state2, ts2 = flat_call(self.env.step, self.lead,
                                    self.env_state, actions)
        tr = self._transition(actions, ts2)
        done = ts2.done
        ep_ret_local = self.ep_ret_local + ts2.reward_local
        if self.cfg.dual_buffer:
            self._stage_and_flush(tr, done, env_state2, ep_ret_local)
        else:
            self.buf = replay.add_batch(self.buf, tr)
        new_state, new_ts, new_goals = self.hooks.episode_init(self.lead,
                                                               self.draws)
        sel = lambda a, b: _where(done, a, b)
        self.env_state = tree_map(sel, new_state, env_state2)
        self.obs = tree_map(sel, new_ts.obs, ts2.obs)
        self.state = tree_map(sel, new_ts.state, ts2.state)
        self.goals = sel(new_goals, self.goals)
        self.a_prev = torch.where(done[..., None], 0, actions)
        self.ep_ret_local = ep_ret_local * (1.0 - done.float()[..., None])
        self.episodes = self.episodes + done.sum(dim=-1)

    def discard(self):
        """Empty the replay (cursor and fill to 0; both memories with the
        dual buffer), as the on-policy driver does after a burst."""
        self.buf = (replay.reset_dual if self.cfg.dual_buffer
                    else replay.reset)(self.buf)

    def sample(self):
        """One minibatch per seed, [S, B, ...], its indices from the draw
        source below each ring's fill."""
        shape = self.lead[:1] + (self.cfg.batch_size,)
        if self.cfg.dual_buffer:
            below = lambda ring: self.draws.randint_below(
                shape, torch.clamp_min(ring.size, 1))
            idx_bad, idx_good = below(self.buf.bad), below(self.buf.good)
            return replay.sample_dual(self.buf, idx_bad, idx_good, 0,
                                      self.cfg.batch_size)
        return replay.sample(self.buf, self.draws.randint(
            shape, max(self.buf.size, 1)))


def seed_states(alg, weights):
    """One flattened state per seed, each network and its target from
    row s of ``weights`` ({name: [S, n]})."""
    states = []
    n_seeds = next(iter(weights.values())).shape[0]
    for s in range(n_seeds):
        ts = alg.empty_state()
        for name, w in weights.items():
            getattr(ts, name).flat.copy_(w[s])
            getattr(ts, name + "_tgt").flat.copy_(w[s])
        states.append(ts)
    return states


def flat_leaves(tree, prefix=""):
    """{dotted name: a CPU copy} of a dict of tensors and dicts."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_leaves(v, prefix + k + "."))
        else:
            out[prefix + k] = v.detach().to("cpu", copy=True)
    return out


GRAD_NAMES = {"Policy": "actor", "Q_global": "qg", "Q_credit": "qc",
              "V": "v"}


def run_reference(config, n_seeds: int, seed: int, weights, device,
                  n_updates: int = 3, tf32: bool = False,
                  cudnn: bool = True):
    """The program's first ``n_updates`` updates of an S-seed sweep,
    recomputed: returns {"losses": [{metric: [S]}, ...], "grads": {net:
    [S, n]} of the first update, "params": {net or net_tgt: [S, n]}
    after the last}, all on the CPU.  ``tf32`` computes the nets'
    products with TF32 (the comparison's control); ``cudnn`` off runs
    the convolutions on PyTorch's own kernels instead of cuDNN's (a
    second float32 reference, ~7x slower, to see how far two lie
    apart)."""
    nets.TF32["on"] = tf32
    saved = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = cudnn
    try:
        return _run(config, n_seeds, seed, weights, device, n_updates)
    finally:
        nets.TF32["on"] = False
        torch.backends.cudnn.enabled = saved


def _offpolicy_chunks(sweep, states):
    """The off-policy training chunks after the fill: each its env steps
    at each seed's epsilon; yields (epsilon [S], the updates that
    follow)."""
    cfg = sweep.cfg
    per_chunk = cfg.updates_per_chunk or cfg.n_envs
    while True:
        eps = torch.as_tensor(epsilons(cfg, sweep.episodes.cpu().numpy()),
                              dtype=torch.float32, device=sweep.device)
        for _ in range(cfg.steps_per_train):
            sweep.step(states, eps)
        yield eps, per_chunk


def _onpolicy_bursts(sweep, states):
    """The on-policy rollout chunks after the fill, at one host epsilon
    for all seeds; yields (epsilon [S], ``epochs``) for each burst, and
    once its updates have run discards the ring and decays epsilon, as
    ``train_vmapped_seeds(onpolicy=True)`` does."""
    cfg = sweep.cfg
    n_seeds = sweep.lead[0]
    eps_scalar, last_train_eps = cfg.epsilon_start, 0
    while True:
        eps = torch.as_tensor(eps_scalar, dtype=torch.float32,
                              device=sweep.device).expand(n_seeds)
        for _ in range(cfg.steps_per_train):
            sweep.step(states, eps)
        emin = int(sweep.episodes.min())
        if emin - last_train_eps >= cfg.episodes_per_train:
            yield eps, cfg.epochs
            last_train_eps = emin
            sweep.discard()
            if eps_scalar > cfg.epsilon_end:
                eps_scalar = max(cfg.epsilon_end,
                                 eps_scalar - cfg.epsilon_step)


def _run(config, n_seeds, seed, weights, device, n_updates):
    sweep = Sweep(config, n_seeds, draw_source(seed, device), device)
    cfg, alg = sweep.cfg, sweep.alg
    states = seed_states(alg, weights)
    while int(sweep.episodes.min()) < cfg.pretrain_episodes:
        for _ in range(cfg.steps_per_train):
            sweep.step()
    losses, grads = [], {}
    lead = (n_seeds, cfg.batch_size)
    chunks = _onpolicy_bursts if sweep.onpolicy else _offpolicy_chunks
    for eps, n_upd in chunks(sweep, states):
        for _ in range(min(n_upd, n_updates - len(losses))):
            first = not losses
            batch = sweep.sample()
            gumbel = alg.update_draws(sweep.draws, lead)
            out = []
            for s, ts in enumerate(states):
                _, m = alg.update(ts, tree_map(lambda x: x[s], batch),
                                  eps[s], gumbel[s], with_grads=first)
                out.append(m)
            losses.append({name: torch.stack([m[name] for m in out]).cpu()
                           for name in out[0] if name != "grads"})
            if first:
                batch1 = flat_leaves(batch)
                grads = {GRAD_NAMES[g]: torch.stack(
                    [m["grads"][g] for m in out]).cpu()
                    for g in out[0]["grads"]}
        if len(losses) >= n_updates:
            break
    params = {}
    for name in alg.net_names():
        for key in (name, name + "_tgt"):
            params[key] = torch.stack([getattr(ts, key).flat
                                       for ts in states]).cpu()
    return {"losses": losses, "grads": grads, "params": params,
            "batch1": batch1}
