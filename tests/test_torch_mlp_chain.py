"""The MLP-chain microbenchmark's plain versions (ops/kernels/mlp_chain.py)
against the Pallas kernels of tools/mlp_microbench.py, on the CPU.

The JAX tool is imported by path and not edited. Its activations run
inside a one-block elementwise pallas_call in interpret mode (its
pl.reciprocal has no evaluation rule outside a kernel), its chain_kernel
and chain_kernel_deferred through pl.pallas_call(..., interpret=True) with
the tool's own BlockSpecs, at T=16, G=3, L=4, on the same seeded numpy
inputs as the port.

At the tool's gate weight of 1e-30 the gates cannot be seen in f32. So the
gated forms are also held against the tool's own functions traced to a
jaxpr with that literal lifted to 1.0 (_lifted), where a wrong gate shows.

Tolerances, with the largest reading on these inputs:
  * activations: 4 f32 ulps relative plus 2.5e-7 absolute (XLA's exp /
    log1p against PyTorch's, composed; the gates 1 - r and 1 - exp(-100 sp)
    cancel near 0, where an ulp of 1.0 is the error). The approximate
    reciprocal of `recip~` (in interpret mode up to 3.9e-3 relative) does
    not show at the gate weight 1e-30; with the gate at 1.0, _lifted makes
    it exact, as the port's plain version takes it.
  * f32 chains: 1e-5 absolute (f32 summation order; read <= 2.3e-6).
  * bf16 chains: 1e-2 absolute. A layer input that lies within rounding of
    a bf16 midpoint rounds to the other neighbour after another f32
    summation order; that moves the next layer by |w| 2^-8 |x| and
    propagates (read 2.4e-3 on `none`, whose values reach 3.3; 5.2e-6 on
    the softplus forms).
  * f32 chains with the gates at 1.0, two layers: 3e-4 absolute. The
    sigmoid gate has slope up to 25 there, so it carries layer 1's f32
    summation-order difference (~1e-6 at |x| ~ 6) 25x into layer 2, and
    again into its output (read <= 6.8e-5, values to ~3). A wrong gate
    moves the output by up to 1.
"""

import importlib.util
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from jax.extend import core as jcore

from color_neus_torch import pin_precision
from color_neus_torch.ops.kernels import mlp_chain as MC
from color_neus_torch.tools import mlp_microbench as tool

pin_precision()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("jax_mlp_microbench",
                                               os.path.join(REPO, "tools", "mlp_microbench.py"))
jmb = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jmb)

JAX_ACTS = {"none": jmb.act_none, "relu": jmb.act_relu, "softplus": jmb.act_softplus,
            "sigmoid": jmb.act_sigmoid, "sp+gate": jmb.act_softplus_gate,
            "shared": jmb.act_shared_gate, "expm1gate": jmb.act_expm1_gate,
            "recip~": jmb.act_recip_approx_gate, "recipNt": jmb.act_recip_newton_gate}
T, G, L = 16, 3, 4
L_GATE = 2
RTOL_ACT, ATOL_ACT = 4 * 2.0 ** -23, 2.5e-7
ATOL_CHAIN = {True: 1e-2, False: 1e-5}
ATOL_GATE_CHAIN = 3e-4


def test_the_variants_are_the_tools():
    assert [n for n, _ in MC.ACTIVATIONS] == list(JAX_ACTS)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(G * T, 256).astype(np.float32)
    w = (0.06 * rng.randn(256, 256)).astype(np.float32)
    return x, w


def _jax_elementwise(fn, x):
    """fn on a [rows, 128] f32 array, inside one interpret-mode kernel."""
    def kern(x_ref, o_ref):
        o_ref[...] = fn(x_ref[...])
    return np.asarray(pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
                                     interpret=True)(x))


def _probe():
    """Seeded values and the edges: 0, the 100 x = 30 threshold and its f32
    neighbours, exp(100 x) overflow (x > ~0.887), exp(-100 |x|) underflow
    (|x| > ~1.04), tiny and large magnitudes; padded to [rows, 128]."""
    rng = np.random.RandomState(3)
    t = np.float32(0.3)
    edges = np.asarray([0.0, -0.0, t, np.nextafter(t, np.float32(1)),
                        np.nextafter(t, np.float32(0)), -t, 0.887, 0.9, -0.9, 1.04, -1.04, 2.0,
                        -2.0, 50.0, -50.0, 1e-8, -1e-8, 1e-3, -1e-3], np.float32)
    v = np.concatenate([edges, np.linspace(-3, 3, 1001, dtype=np.float32),
                        (0.05 * rng.randn(1000)).astype(np.float32)])
    return np.pad(v, (0, -v.size % 128)).reshape(-1, 128)


@pytest.mark.parametrize("name", list(JAX_ACTS))
def test_activation_matches_jax(name):
    x = _probe()
    want = _jax_elementwise(JAX_ACTS[name], x)
    got = MC.ACT_BY_NAME[name](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL_ACT, atol=ATOL_ACT)


def test_sp_only_matches_jax():
    x = _probe()
    np.testing.assert_allclose(MC.act_sp_only(torch.from_numpy(x)).numpy(),
                               _jax_elementwise(jmb.act_sp_only_gate_from_out, x),
                               rtol=RTOL_ACT, atol=ATOL_ACT)


def _lifted(fn, *args, gates):
    """The JAX tool's fn traced at args, with its gate weight (the literal
    1e-30, `gates` of them) lifted to 1.0 and its pl.reciprocal made exact,
    as the port's plain versions take it; returns a function of args that
    returns a list of outputs."""
    closed = jax.make_jaxpr(fn)(*args)
    eqns, lifted = [], 0
    for e in closed.jaxpr.eqns:
        invars = []
        for v in e.invars:
            if isinstance(v, jcore.Literal) and np.asarray(v.val).dtype == np.float32 \
                    and np.asarray(v.val) == np.float32(MC.GATE_W):
                v, lifted = jcore.Literal(np.float32(1.0), v.aval), lifted + 1
            invars.append(v)
        params = dict(e.params, approx=False) if e.primitive.name == "reciprocal" else e.params
        eqns.append(e.replace(invars=invars, params=params))
    assert lifted == gates
    return jcore.jaxpr_as_fun(jcore.ClosedJaxpr(closed.jaxpr.replace(eqns=eqns), closed.consts))


@pytest.mark.parametrize("name", MC.GATED)
def test_gate_at_weight_one_matches_jax(name):
    """Each gated form with its gate at weight 1.0 against the tool's own
    function lifted to 1.0: a swapped select or a wrong sigmoid scale
    moves the output by up to 1 here."""
    x = _probe()
    fn = _lifted(JAX_ACTS[name], x, gates=1)
    want = _jax_elementwise(lambda v: fn(v)[0], x)
    got = MC.ACT_BY_NAME[name](torch.from_numpy(x), 1.0).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL_ACT, atol=ATOL_ACT)


def _jax_chain(kernel, x, w):
    spec = dict(memory_space=pltpu.VMEM)
    fn = pl.pallas_call(
        kernel, grid=(G,),
        in_specs=[pl.BlockSpec((T, 256), lambda i: (i, 0), **spec),
                  pl.BlockSpec((256, 256), lambda i: (0, 0), **spec)],
        out_specs=pl.BlockSpec((T, 256), lambda i: (i, 0), **spec),
        out_shape=jax.ShapeDtypeStruct((G * T, 256), jnp.float32), interpret=True)
    return np.asarray(fn(x, w))


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", list(JAX_ACTS))
def test_chain_matches_jax(name, bf16):
    x, w = _inputs(MC.act_id(name))
    want = _jax_chain(partial(jmb.chain_kernel, L, JAX_ACTS[name], bf16), x, w)
    got = MC.chain_plain(torch.from_numpy(x), torch.from_numpy(w), L, name, bf16).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_CHAIN[bf16])


def test_chain_deferred_matches_jax():
    x, w = _inputs(11)
    want = _jax_chain(partial(jmb.chain_kernel_deferred, L), x, w)
    got = MC.chain_deferred_plain(torch.from_numpy(x), torch.from_numpy(w), L).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_CHAIN[True])


class _Ref:
    """Stands in for a Pallas ref when a kernel body is traced as a
    function of arrays."""

    def __init__(self, v=None):
        self.v = v

    def __getitem__(self, idx):
        return self.v[idx]

    def __setitem__(self, idx, v):
        self.v = v


def _lifted_kernel(body, x, w, gates):
    """A Pallas kernel of (x_ref, w_ref, o_ref) running the tool's kernel
    body `body(x_ref, w_ref, o_ref)` with its gates lifted to 1.0."""
    def as_arrays(xv, wv):
        o = _Ref()
        body(_Ref(xv), _Ref(wv), o)
        return o.v
    fn = _lifted(as_arrays, x[:T], w, gates=gates)

    def kernel(x_ref, w_ref, o_ref):
        o_ref[...] = fn(x_ref[...], w_ref[...])[0]
    return kernel


@pytest.mark.parametrize("name", MC.GATED)
def test_chain_at_gate_weight_one_matches_jax(name):
    """The f32 chain of each gated form with its gate at 1.0 against the
    tool's chain_kernel lifted to 1.0, over two layers (L_GATE gates)."""
    x, w = _inputs(20 + MC.act_id(name))
    kernel = _lifted_kernel(partial(jmb.chain_kernel, L_GATE, JAX_ACTS[name], False), x, w,
                            L_GATE)
    want = _jax_chain(kernel, x, w)
    got = MC.chain_plain(torch.from_numpy(x), torch.from_numpy(w), L_GATE, name, False,
                         1.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_GATE_CHAIN)


def test_chain_deferred_at_gate_weight_one_matches_jax():
    """The deferred chain with its gates at 1.0 against the tool's
    chain_kernel_deferred lifted to 1.0 (L - 1 gates)."""
    x, w = _inputs(12)
    want = _jax_chain(_lifted_kernel(partial(jmb.chain_kernel_deferred, L), x, w, L - 1), x, w)
    got = MC.chain_deferred_plain(torch.from_numpy(x), torch.from_numpy(w), L, 1.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_CHAIN[True])


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """A CPU tensor goes to the plain version, counts no launch; bad inputs
    raise."""
    x, w = (torch.from_numpy(a) for a in _inputs(5))
    before = (MC.launch_chain.launches, MC.launch_chain_deferred.launches)
    got = MC.launch_chain(x, w, 2, MC.act_softplus, gate_w=1.0)
    torch.testing.assert_close(got, MC.chain_plain(x, w, 2, "softplus", gate_w=1.0),
                               rtol=0, atol=0)
    torch.testing.assert_close(MC.launch_chain_deferred(x, w, 3),
                               MC.chain_deferred_plain(x, w, 3), rtol=0, atol=0)
    assert (MC.launch_chain.launches, MC.launch_chain_deferred.launches) == before
    with pytest.raises(ValueError):
        MC.launch_chain(x[:, :128].contiguous(), w, 2, "none")
    with pytest.raises(ValueError):
        MC.launch_chain(x.double(), w, 2, "none")
    with pytest.raises(ValueError):
        MC.launch_chain(x, w, 2, "gelu")


def test_the_gates_show_at_weight_one():
    """At the tool's 1e-30 the gate is invisible; at 1.0 each gated form
    adds its gate, in (0, 1)."""
    x = torch.linspace(-0.05, 0.05, 101)
    for name in MC.GATED:
        fn = MC.ACT_BY_NAME[name]
        g = fn(x, 1.0) - fn(x, 0.0)
        assert torch.equal(fn(x), fn(x, 0.0)), name
        assert bool(((g > 0) & (g < 1)).all()), name


def test_tool_runs_on_the_cpu(capsys):
    """The tool's run and run_deferred at a tiny size with device="cpu"."""
    assert tool.run(16, 2, 2, MC.act_softplus, "softplus", device="cpu") > 0
    assert tool.run_deferred(16, 2, 2, device="cpu") > 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("softplus   T=   16 L=2 G=2:")
    assert lines[1].startswith("deferred   T=   16 L=2 G=2:")
    assert all(line.endswith("TFLOP/s  (cpu, host clock)") for line in lines)


def test_tool_sweep_is_the_jax_tools(monkeypatch):
    """main() makes the JAX tool's sweep, line for line: each tool's run and
    run_deferred are replaced by recorders, so nothing runs."""
    def recorder(calls):
        def run(T, L, G, act, name, bf16=True, device=None):
            calls.append((name, T, L, G, act.__name__, bf16))
            return 1.0

        def run_deferred(T, L, G, device=None):
            calls.append(("deferred", T, L, G, None, True))
            return 1.0
        return run, run_deferred

    ours, theirs = [], []
    for mod, calls in ((tool, ours), (jmb, theirs)):
        run, run_deferred = recorder(calls)
        monkeypatch.setattr(mod, "run", run)
        monkeypatch.setattr(mod, "run_deferred", run_deferred)
    lines = tool.main(["--device", "cpu"])
    jmb.main()
    assert ours == theirs and len(ours) == 9 + 1 + 6 + 1
    assert lines == [(name, T, L, G, 1.0) for name, T, L, G, _, _ in ours]
