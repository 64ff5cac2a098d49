"""The port's Checkers nets against the flax nets: forwards after
``convert`` (at most 1e-5 apart), the flat buffer's order against
``ravel_pytree``, and the init schemes; the seed-stacked convolution
(``ops/seed_conv.py``) on the CPU: the nets' code before it bit for bit,
its ``vmap`` rule and autograd with the kernels' plain versions in the
kernels' place, and the shapes it refuses."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from cm3_tpu.models import nets as jnets
from cm3_tpu_torch import convert
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.models import nets as tnets
from cm3_tpu_torch.ops import seed_conv
from tests import torch_parity as tp

tp.set_torch_cpu()

SPEC = dict(rows_state=3, columns_state=9, channels_state=2, l_state_one=4,
            l_obs_others=2, l_obs_self=4, rows_obs=5, columns_obs=5,
            channels_obs=3, l_action=5, l_goal=2, n_agents=2)
FULL_NN = dict(Q_conv_f=4, Q_conv_k=(3, 5), Q_n_h1_1=256, Q_n_h1_2=32,
               Q_n_h2=256, A_conv_f=6, A_conv_k=(3, 3), A_n_h1=256,
               A_n_h2=256)
# parameter counts of the full-width nets (flat buffer sizes)
FULL_SIZES = {"actor": 149645, "qg": 144741, "qc": 144709}
B = 24


def _pair(name, nn):
    """(flax module, torch module, example inputs as numpy)."""
    rng = np.random.default_rng(0)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    a1h = lambda: np.eye(5, dtype=np.float32)[rng.integers(0, 5, B)]
    if name == "actor":
        kw = dict(conv_f=nn["A_conv_f"], conv_k=nn["A_conv_k"],
                  n_h1=nn["A_n_h1"], n_h2=nn["A_n_h2"], stage=2)
        return (jnets.ActorCheckers(n_actions=5, **kw),
                tnets.ActorCheckers(SPEC, **kw),
                [a1h(), f(B, 5, 5, 3), f(B, 4), f(B, 2), f(B, 2)])
    kw = dict(conv_f1=nn["Q_conv_f"], conv_k1=nn["Q_conv_k"],
              n_h1_1=nn["Q_n_h1_1"], n_h1_2=nn["Q_n_h1_2"],
              n_h2=nn["Q_n_h2"], stage=2)
    if name == "qg":
        return (jnets.QGlobalCheckers(**kw), tnets.QGlobalCheckers(SPEC, **kw),
                [f(B, 3, 9, 2), f(B, 4), f(B, 2), a1h(), f(B, 4),
                 a1h()[:, None], f(B, 5, 5, 3), f(B, 4)])
    return (jnets.QCreditCheckers(**kw), tnets.QCreditCheckers(SPEC, **kw),
            [f(B, 3, 9, 2), f(B, 4), f(B, 2), a1h(), f(B, 4), f(B, 4),
             f(B, 5, 5, 3), f(B, 4)])


def _loaded(name, nn, seed=0):
    jmod, tmod, inputs = _pair(name, nn)
    params = jmod.init(jax.random.PRNGKey(seed), *map(jnp.asarray, inputs))
    # perturb the zero-initialised biases so the test sees their layout
    params = jax.tree_util.tree_map(
        lambda x: x + 0.01 * jnp.arange(x.size, dtype=x.dtype).reshape(
            x.shape) / x.size, params)
    tmod = tnets.flatten_parameters(tmod)
    convert.load_params(tmod, jax.device_get(params))
    return jmod, tmod, params, inputs


@pytest.mark.parametrize("width", ["small", "full"])
@pytest.mark.parametrize("name", ["actor", "qg", "qc"])
def test_forward_matches_flax_after_convert(name, width):
    """Tolerance 1e-5: float32 sums in another order (XLA vs PyTorch
    CPU convolutions and matmuls) over at most ~300 terms."""
    nn = tp.SMALL_NN if width == "small" else FULL_NN
    jmod, tmod, params, inputs = _loaded(name, nn)
    want = np.asarray(jmod.apply(params, *map(jnp.asarray, inputs)))
    with torch.no_grad():
        got = tmod(*map(torch.from_numpy, inputs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if width == "full":
        assert tmod.flat.numel() == FULL_SIZES[name]


@pytest.mark.parametrize("name", ["actor", "qg", "qc"])
def test_flat_buffer_follows_ravel_pytree_order(name):
    """Leaf by leaf, the flat buffer holds ravel_pytree's vector, each
    leaf transposed to the torch layout; ``flat_to_torch`` of the
    ravelled params is the loaded buffer itself."""
    jmod, tmod, params, _ = _loaded(name, tp.SMALL_NN)
    vec, _ = ravel_pytree(params)
    np.testing.assert_array_equal(
        convert.flat_to_torch(tmod, np.asarray(vec)).numpy(),
        tmod.flat.numpy())
    paths = [tnets.flax_path(n) for n, _ in tnets.ordered_parameters(tmod)]
    leaves = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    assert paths == [tuple(k.key for k in p) for p, _ in leaves]
    for (n, p), (_, leaf) in zip(tnets.ordered_parameters(tmod), leaves):
        assert p.data_ptr() >= tmod.flat.data_ptr()   # a view into flat
        assert p.numel() == leaf.size


def test_conv_branch_matches_flax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, 13, 9, 2)).astype(np.float32)
    jmod = jnets.ConvBranch(conv_f=4, conv_k=(5, 3), n_reduced=16, n_h2=8)
    params = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x))
    tmod = tnets.flatten_parameters(
        tnets.ConvBranch((13, 9, 2), 4, (5, 3), 16, 8))
    convert.load_params(tmod, jax.device_get(params))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmod.apply(params, x)),
                               rtol=1e-5, atol=1e-5)


def _init(scheme):
    mod = tnets.ActorCheckers(SPEC, conv_f=6, conv_k=(3, 3), n_h1=64,
                              n_h2=64, stage=2)
    tnets.init_parameters(mod, torch.Generator().manual_seed(0), scheme)
    return dict(mod.named_parameters())


@pytest.mark.parametrize("scheme", ["ref", "tf1", "trunc001"])
def test_init_schemes(scheme):
    """Bounds of each initializer (nets.py:47-92): Glorot-uniform
    kernels (trunc-normal 0.01 under trunc001), zero biases,
    trunc-normal 0.01 W_h2, and b zero except under tf1."""
    p = _init(scheme)
    for name, x in p.items():
        x = x.detach()
        leaf = name.split(".")[-1]
        if leaf == "bias":
            assert torch.all(x == 0)
        elif leaf == "W_h2" or (leaf == "weight" and scheme == "trunc001"):
            assert x.abs().max() <= 0.02 and x.std() > 0.004
        elif leaf == "weight":
            fan_in, fan_out = tnets._fans(tuple(x.shape))
            lim = (6.0 / (fan_in + fan_out)) ** 0.5
            assert x.abs().max() <= lim and x.abs().max() > 0.8 * lim
        elif leaf == "b":
            if scheme == "tf1":
                lim = (3.0 / x.numel()) ** 0.5
                assert x.abs().max() <= lim and x.abs().max() > 0.5 * lim
            else:
                assert torch.all(x == 0)
    with pytest.raises(ValueError):
        tnets.init_scheme("xavier")


def test_checkers_nn_config_reads_stage2_json():
    """The stage-2 JSON's widths, its IAC critic's among them (V_n_h2
    256 over the generic default 64)."""
    assert tcfg.checkers_nn_config(2) == tcfg.NNConfig(
        **FULL_NN, V_conv_f=6, V_conv_k=(3, 3), V_n_h1_1=256, V_n_h1_2=32,
        V_n_h2=256)
    assert tcfg.NNConfig().V_n_h2 == 64
    env = tcfg.checkers_env_config(2)
    assert (env.n_agents, env.agents_r, env.agents_c) == (2, (0, 2), (8, 8))


# (H, W, C, F, kh, kw) of every conv a ``_conv`` call site of
# models/nets.py builds at the benchmark cells' widths: the Checkers state
# grid (critics, V ablation, COMA, the QMIX mixer), its observation (actor,
# critics, IAC critic, QMIX's agent net), the central-V critic, and
# roadway's grid (``ConvBranch``)
CONV_SHAPES = {"state_grid": (3, 9, 2, 4, 3, 5),
               "observation": (5, 5, 3, 6, 3, 3),
               "central_v": (3, 9, 2, 2, 3, 5),
               "roadway_grid": (13, 9, 2, 4, 5, 3)}


def _relu_flat_conv_before(conv, t_nhwc):
    """``nets._relu_flat_conv`` as it was before the seed-stacked op."""
    c = torch.nn.functional.relu(conv(t_nhwc.permute(0, 3, 1, 2)))
    return c.permute(0, 2, 3, 1).reshape(c.shape[0], -1)


class _OneConv(torch.nn.Module):
    """One conv whose forward is ``fn(conv, x)``, for ``functional_call``."""

    def __init__(self, shape):
        super().__init__()
        _, _, c, f, kh, kw = shape
        self.conv = tnets._conv(c, f, (kh, kw))

    def forward(self, x, fn):
        return fn(self.conv, x)


def _conv_run(shape, seeds, fn, rows=37):
    """``fn`` over a conv of ``shape`` at ``rows`` rows, one module or a
    ``SeedStack`` of ``seeds`` under ``vmap``: (output, flat gradient of
    a fixed weighting of it, the module or stack)."""
    h, w, c, f, _, _ = shape
    gen = torch.Generator().manual_seed(7)
    mod = _OneConv(shape)
    lead = () if seeds is None else (seeds,)
    x = torch.randn(lead + (rows, h, w, c), generator=gen)
    if seeds is None:
        net = tnets.flatten_parameters(mod)
        with torch.no_grad():
            net.flat.copy_(torch.randn(net.flat.shape, generator=gen))
        out = mod(x, fn)
    else:
        net = tnets.SeedStack(mod, seeds)
        with torch.no_grad():
            net.flat.copy_(torch.randn(net.flat.shape, generator=gen))
        out = torch.func.vmap(
            lambda p, xs: torch.func.functional_call(mod, p, (xs, fn)))(
                net.params, x)
    weights = torch.randn(out.shape, generator=gen)
    (out * weights).sum().backward()
    return out.detach(), net.flat_grad.clone(), net


@pytest.mark.parametrize("seeds", [None, 3], ids=["module", "seeds3"])
@pytest.mark.parametrize("shape", sorted(CONV_SHAPES))
def test_seed_conv_on_cpu_is_the_code_before(shape, seeds):
    """On the CPU ``_relu_flat_conv`` takes the plain version, which is the
    nets' code before the seed-stacked op: forward and the weight and bias
    gradients bit for bit, one module and three seeds under ``vmap``; no
    kernel launch is counted."""
    before = seed_conv.relu_flat_conv.launches
    got = _conv_run(CONV_SHAPES[shape], seeds, tnets._relu_flat_conv)
    want = _conv_run(CONV_SHAPES[shape], seeds, _relu_flat_conv_before)
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a, b)
    assert seed_conv.relu_flat_conv.launches == before == 0


# shapes no net of the cells builds: an even kernel (padded as
# ``nn.Conv2d(padding="same")`` pads it) and more filters than a launch takes
EDGE_SHAPES = {"even_kernel": (4, 5, 2, 3, 2, 4),
               "eleven_filters": (3, 4, 2, 11, 3, 3)}


@pytest.mark.parametrize("seeds", [None, 3], ids=["module", "seeds3"])
@pytest.mark.parametrize("shape", sorted(CONV_SHAPES) + sorted(EDGE_SHAPES))
def test_seed_conv_function_with_plain_kernels(monkeypatch, shape, seeds):
    """The card's path (the autograd Function and its ``vmap`` rule) on
    the CPU, with the kernels' plain versions in the kernels' place: one
    call of each for all seeds, the seed stack's weights handed over in
    place (no copy), and the same output and gradients as the plain path
    within float32 rounding (the plain version sums in another order: 1e-5
    relative, and 1e-5 of the largest magnitude absolute)."""
    calls = []

    def forward(x, weight, bias):
        seed_conv.check(x, weight, bias)
        calls.append(("forward", x.shape[0], weight.data_ptr()))
        return seed_conv.forward_plain(x, weight, bias)

    def wgrad(g, y, x, kh, kw):
        calls.append(("wgrad", x.shape[0]))
        return seed_conv.wgrad_plain(g, y, x, kh, kw)

    monkeypatch.setattr(seed_conv, "_forward_kernel", forward)
    monkeypatch.setattr(seed_conv, "_wgrad_kernel", wgrad)
    card = lambda conv, t: seed_conv._one_seed(t, conv.weight, conv.bias)
    shape = {**CONV_SHAPES, **EDGE_SHAPES}[shape]
    got = _conv_run(shape, seeds, card)
    assert [c[:2] for c in calls] == [("forward", seeds or 1),
                                      ("wgrad", seeds or 1)]
    if seeds:   # the stack's own buffer, not a copy
        assert calls[0][2] == got[2].params["conv.weight"].data_ptr()
    want = _conv_run(shape, seeds, tnets._relu_flat_conv)
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))
    with pytest.raises(ValueError, match="input gradient"):
        x = torch.zeros((2,) + shape[:3], requires_grad=True)
        card(_OneConv(shape).conv, x)


def _stacked(s=3, r=5, h=3, w=9, c=2, f=4, kh=3, kw=5, **over):
    """Stacked (x, weight, bias), with any of them replaced by ``over``."""
    args = dict(x=torch.zeros(s, r, h, w, c),
                weight=torch.zeros(s, f, c, kh, kw),
                bias=torch.zeros(s, f))
    args.update(over)
    return args["x"], args["weight"], args["bias"]


META = dict(device="meta")
REFUSED = {
    "float64": dict(x=torch.zeros(3, 5, 3, 9, 2, dtype=torch.float64)),
    "rank": dict(x=torch.zeros(5, 3, 9, 2)),
    "channels_disagree": dict(weight=torch.zeros(3, 4, 3, 3, 5)),
    "seeds_disagree": dict(weight=torch.zeros(2, 4, 2, 3, 5)),
    "bias_shape": dict(bias=torch.zeros(3, 5)),
    "no_filters": dict(weight=torch.zeros(3, 0, 2, 3, 5),
                       bias=torch.zeros(3, 0)),
    "no_rows": dict(x=torch.zeros(3, 0, 3, 9, 2)),
    "devices_differ": dict(x=torch.zeros(3, 5, 3, 9, 2, **META)),
    "past_65535_seeds": dict(x=torch.zeros(65536, 1, 3, 9, 2, **META),
                             weight=torch.zeros(65536, 4, 2, 3, 5, **META),
                             bias=torch.zeros(65536, 4, **META)),
    "indices_past_32_bits": dict(x=torch.zeros(256, 2 ** 20, 3, 9, 2,
                                               **META),
                                 weight=torch.zeros(256, 4, 2, 3, 5, **META),
                                 bias=torch.zeros(256, 4, **META)),
}


@pytest.mark.parametrize("case", sorted(REFUSED) + ["taken"])
def test_seed_conv_check_refuses_what_the_kernels_do_not_take(case):
    """``check`` passes the port's shapes (every seed count the kernels'
    grid holds) and raises ValueError on each shape or type the kernels do
    not take."""
    if case == "taken":
        for h, w, c, f, kh, kw in CONV_SHAPES.values():
            for s in (1, 256, 65535):
                got = seed_conv.check(*_stacked(
                    s=s, r=1, h=h, w=w, c=c, f=f, kh=kh, kw=kw))
                assert got == (s, 1, h, w, c, f, kh, kw)
        return
    with pytest.raises(ValueError):
        seed_conv.check(*_stacked(**REFUSED[case]))


# shapes past what one launch or a block's shared memory takes: the kernels
# take them all the same (filters in groups, operands from global memory)
TAKEN = {
    "even_kernel": dict(weight=torch.zeros(3, 4, 2, 2, 4)),
    "nine_filters": dict(weight=torch.zeros(3, 9, 2, 3, 5),
                         bias=torch.zeros(3, 9)),
    "past_256_taps": dict(x=torch.zeros(3, 5, 3, 9, 12),
                          weight=torch.zeros(3, 4, 12, 5, 5)),
    "images_past_the_shared_memory": dict(x=torch.zeros(3, 5, 40, 40, 2)),
}


@pytest.mark.parametrize("case", sorted(TAKEN))
def test_seed_conv_check_takes_any_size(case):
    x, weight, bias = _stacked(**TAKEN[case])
    assert seed_conv.check(x, weight, bias) == (*x.shape, *weight.shape[1:2],
                                                *weight.shape[-2:])


def _over(ptr, shape, strides):
    """A float32 CPU tensor of ``shape`` and ``strides`` over the memory at
    ``ptr``, as a C entry sees its arguments."""
    n = 1 + sum((d - 1) * st for d, st in zip(shape, strides))
    buf = (ctypes.c_float * n).from_address(ptr)
    return torch.frombuffer(buf, dtype=torch.float32).as_strided(shape,
                                                                 strides)


class _PlainEntries:
    """The seed-stacked convolution's C entries in plain PyTorch over the
    pointers they are handed (CPU tensors), recording each launch's
    filters: the wrapper's filter groups on the CPU."""

    def __init__(self):
        self.filters = []

    def cm3_seed_conv_forward(self, x, w, w_stride, b, b_stride, out, s, r,
                              h, wd, c, f, kh, kw, stream):
        k = c * kh * kw
        xs = _over(x, (s, r, h, wd, c), (r * h * wd * c, h * wd * c,
                                         wd * c, c, 1))
        ws = _over(w, (s, f, c, kh, kw), (w_stride, k, kh * kw, kw, 1))
        bs = _over(b, (s, f), (b_stride, 1))
        _over(out, (s, r, h * wd * f), (r * h * wd * f, h * wd * f, 1)) \
            .copy_(seed_conv.forward_plain(xs, ws, bs))
        self.filters.append(f)
        return 0

    def cm3_seed_conv_wgrad(self, g, y, x, partial, dw, db, s, r, h, wd, c,
                            f, kh, kw, n_slices, stream):
        assert n_slices == seed_conv.slices(r, h, wd)
        flat = (s, r, h * wd * f), (r * h * wd * f, h * wd * f, 1)
        got = seed_conv.wgrad_plain(
            _over(g, *flat), _over(y, *flat),
            _over(x, (s, r, h, wd, c), (r * h * wd * c, h * wd * c, wd * c,
                                        c, 1)), kh, kw)
        k = c * kh * kw
        _over(dw, (s, f, c, kh, kw), (f * k, k, kh * kw, kw, 1)) \
            .copy_(got[0])
        _over(db, (s, f), (f, 1)).copy_(got[1])
        self.filters.append(f)
        return 0


@pytest.mark.parametrize("f", [8, 11, 19])
def test_seed_conv_entries_run_filters_in_groups(f):
    """``forward_entry`` and ``wgrad_entry`` hand the C entries at most
    ``MAX_FILTERS`` filters a launch, each group's weights in place at the
    seed stack's stride, and put each group's output and gradients back
    in order: with plain entries, the plain versions' results on all
    filters (the output bit for bit; the gradients to float32 rounding,
    a product's order may follow its width)."""
    gen = torch.Generator().manual_seed(f)
    s, r, h, w, c, kh, kw = 3, 5, 3, 9, 2, 3, 5
    x = torch.randn((s, r, h, w, c), generator=gen)
    row = torch.randn((s, f * c * kh * kw + f + 5), generator=gen)
    weight = row[:, :f * c * kh * kw].unflatten(1, (f, c, kh, kw))
    bias = row[:, f * c * kh * kw:-5]
    g = torch.randn((s, r, h * w * f), generator=gen)
    lib = _PlainEntries()
    out = seed_conv.forward_entry(lib, x, weight, bias)
    dw, db = seed_conv.wgrad_entry(lib, g, out, x, kh, kw)
    groups = [min(seed_conv.MAX_FILTERS, f - f0)
              for f0 in range(0, f, seed_conv.MAX_FILTERS)]
    assert lib.filters == groups * 2
    assert torch.equal(out, seed_conv.forward_plain(x, weight, bias))
    for a, b in zip((dw, db), seed_conv.wgrad_plain(g, out, x, kh, kw)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_seed_conv_refuses_devices_without_a_kernel():
    x, weight, bias = _stacked(**{k: v.to("meta") for k, v in zip(
        ("x", "weight", "bias"), _stacked())})
    with pytest.raises(RuntimeError, match="no kernel"):
        seed_conv.relu_flat_conv(x[0], weight[0], bias[0])
