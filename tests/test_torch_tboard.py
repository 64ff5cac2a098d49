"""The port's TensorBoard writer (``cm3_tpu_torch.train.tboard``)
against the JAX package's, byte for byte with the wall clock and the
host name pinned: the encoding (scalars, histograms of any values), and
``log_train_state`` of a port state converted from a JAX state
(``convert.state_from_jax``) against JAX's ``log_train_state`` of that
state: CM3 at stage 1 and at stage 2 (with V, on the optax path, with
the global-norm clip, and fused), COMA, QMIX, and seeds stacked S = 3
row by row.  Equal bytes mean equal tags in JAX's order, equal steps,
and histograms of the leaves in flax layout summed in JAX's order."""

import glob
import os
import socket
import time

import jax
import numpy as np
import pytest

from cm3_tpu.train import tboard as jtb
from cm3_tpu_torch import convert
from cm3_tpu_torch.train import tboard as ttb
from tests import torch_parity as tp

tp.set_torch_cpu()


@pytest.fixture
def pinned(monkeypatch):
    """One wall time and host name for both writers."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    monkeypatch.setattr(socket, "gethostname", lambda: "host")


def event_bytes(log_dir):
    files = glob.glob(os.path.join(log_dir, "events.out.tfevents.*"))
    assert len(files) == 1, files
    with open(files[0], "rb") as f:
        return os.path.basename(files[0]), f.read()


def both(tmp_path, write_jax, write_port):
    """The event file each writer makes: (JAX's, the port's)."""
    out = []
    for name, fn, mod in (("jax", write_jax, jtb), ("port", write_port, ttb)):
        w = mod.SummaryWriter(str(tmp_path / name))
        fn(w)
        w.close()
        out.append(event_bytes(str(tmp_path / name)))
    return out


@pytest.mark.parametrize("case", ["normal", "wide", "special", "ints",
                                  "empty"])
def test_writer_equals_jax(tmp_path, pinned, case):
    rng = np.random.default_rng(len(case))
    data = {
        "normal": rng.normal(0.0, 0.01, (64, 32)).astype(np.float32),
        "wide": (rng.standard_cauchy(5000) * 1e3).astype(np.float32),
        "special": np.array([0.0, -0.0, 1e-30, -1e25, np.nan, np.inf,
                             3.0], np.float32),
        "ints": np.arange(-5, 17),
        "empty": np.zeros((0,), np.float32),
    }[case]

    def write(w):
        w.scalar("loss/Q_global", 0.125, 100)
        w.scalar("r_eval_local/agent_1", -3.5, 2 ** 40)
        w.histogram(f"vars/{case}", data, 7)
        w.flush()

    (jname, jb), (tname, tb) = both(tmp_path, write, write)
    assert tname == jname
    assert tb == jb


def _perturbed(jts, seed):
    """The JAX state with every float leaf moved by noise (the Adam
    moments too), so that no histogram is of zeros."""
    rng = np.random.default_rng(seed)

    def move(x):
        x = np.asarray(x)
        if not np.issubdtype(x.dtype, np.floating):
            return x
        return (x + rng.normal(0.0, 0.05, x.shape)).astype(x.dtype)
    return jax.tree_util.tree_map(move, jax.device_get(jts))


def _jax_state(ja, je, n_seeds=None):
    batch = tp.replay_batch(je, 4, np.random.default_rng(0))
    init = lambda k: ja.init_state(k, batch["obs"], batch["state"],
                                   batch["goals"])
    if n_seeds is None:
        return init(jax.random.PRNGKey(1))
    return jax.vmap(init)(jax.random.split(jax.random.PRNGKey(1), n_seeds))


CASES = {
    "cm3_s1": ("cm3", 1, dict(fused_opt=False)),
    "cm3_s2_V": ("cm3", 2, dict(fused_opt=False, use_V=True)),
    "cm3_s2_clip": ("cm3", 2, dict(fused_opt=False, grad_clip=1.0)),
    "cm3_s2_fused": ("cm3", 2, {}),
    "coma": ("baseline", 2, dict(use_Q=True)),
    "iac_clip": ("baseline", 2, dict(use_V=True, IAC=True, grad_clip=10.0)),
    "qmix": ("qmix", 2, {}),
}


def _algs(kind, stage, opts, n_seeds=None):
    je, _ = tp.envs(n_agents=2 if stage == 2 else 1)
    if kind == "cm3":
        ja, ta = tp.algs(je.spec(), n_seeds=n_seeds, **opts)
    else:
        ja, ta = tp.other_algs(kind, je.spec(), n_seeds=n_seeds, **opts)
    return je, ja, ta


@pytest.mark.parametrize("name", sorted(CASES))
def test_log_train_state_equals_jax(tmp_path, pinned, name):
    je, ja, ta = _algs(*CASES[name])
    jts = _perturbed(_jax_state(ja, je), 3)
    tts = convert.state_from_jax(ta, jts)
    (_, jb), (_, tb) = both(
        tmp_path, lambda w: jtb.log_train_state(w, jts, 11),
        lambda w: ttb.log_train_state(w, tts, 11))
    assert len(jb) > 1000
    assert tb == jb


def test_jax_leaves_names_and_layouts():
    """The names are JAX's ``tree_leaves_with_path`` names of the float
    leaves, in its order; every leaf equals JAX's (flax layout)."""
    je, ja, ta = _algs("cm3", 2, dict(fused_opt=False, grad_clip=1.0,
                                      use_V=True))
    jts = _perturbed(_jax_state(ja, je), 4)
    got = convert.jax_leaves(convert.state_from_jax(ta, jts))
    want = []
    for path, leaf in jax.tree_util.tree_leaves_with_path(jts):
        if np.issubdtype(np.asarray(leaf).dtype, np.floating):
            want.append(("/".join(
                str(getattr(p, "key", getattr(p, "name", p)))
                .strip(".[]'\"") for p in path), np.asarray(leaf)))
    assert [n for n, _ in got] == [n for n, _ in want]
    names = dict(got)
    assert "opt_v/1/0/nu" in names and "opt_actor/1/0/mu" in names
    assert any(n.startswith("v_tgt/params/") for n in names)
    for (n, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=n)


@pytest.mark.parametrize("kind", ["cm3", "qmix"])
def test_seed_rows_equal_jax(tmp_path, pinned, kind):
    """A stacked state of S = 3 written seed by seed equals JAX's writer
    on each seed's slice of the JAX stack."""
    je, ja, ta = _algs(kind, 2, {}, n_seeds=3)
    jts = _perturbed(_jax_state(ja, je, n_seeds=3), 5)
    tts = convert.state_from_jax(ta, jts)
    for i in range(3):
        ji = jax.tree_util.tree_map(lambda x: np.asarray(x)[i], jts)
        (_, jb), (_, tb) = both(
            tmp_path / str(i), lambda w: jtb.log_train_state(w, ji, i),
            lambda w: ttb.log_train_state(w, tts, i, seed=i))
        assert tb == jb, i
