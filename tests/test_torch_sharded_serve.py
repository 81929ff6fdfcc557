"""Sharded serving (``models.model`` ``prefill`` and ``decode_step`` under
``sharding.axis_rules(mesh, rules_for("serve", ...))``) against the JAX
package, on the CPU.

The port runs in two worlds of 8 gloo ranks (``launch.mesh.run_world``;
the rank side is ``tests/torch_sharded_worker.py``, which imports no jax),
on (2, 4) and (4, 2) data x model meshes. Each arch runs at ``.reduced()``
widths in float32 with ``fsdp`` on and off: a prefill of B=4 prompts of 28
tokens, then 6 decode steps at positions 28..33, which cross the wrap of
every cache of 30 or 32 slots (the ring of recurrentgemma's local layers,
of llama4-scout's chunked ones, and the dense global caches alike). The
cache length picks the layout ``spec_for`` gives the K/V leaves: 32 slots
split over their sequence on either mesh; 30 on model 4 split by KV heads
(granite, mistral, grok, llama4: 4 KV heads) or whole (recurrentgemma: 1
KV head), and on model 2 split over their sequence. llama4-scout runs the
all-to-all rules (its prefill takes the all-to-all MoE branch on (2, 4),
where its 4 experts match the model axis, at capacity factor 4 so no copy
drops; its decode the Megatron branch), grok-1 top-2 the Megatron branch.

Checks: every step's logits within 1e-4 of the JAX package's one-device
``prefill`` / ``decode_step`` (jitted, in this process) and, for one run
a mesh and arch (``JAX_SHARDED_RUNS``), of its own sharded ones (jitted
under the same rules on 8 host devices in a subprocess, the caches
placed as ``build_decode`` places them); the
gathered caches after the last step within 1e-5 of the one-device
reference's; every cache leaf's placements (after prefill and after the
steps) equal to the reference's ``spec_for`` over ``cache_specs``;
each refusal of the sharded path, one case each; and
``sharding.row_parallel``'s autograd Function, its product and gradient.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, list_archs
from repro.models import model as JM
from repro.models import sharding as JS
from repro.models.param import Spec as JSpec
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.launch import mesh as TMESH
from repro_torch.models import sharding as TS
from repro_torch.models.param import iter_leaves

import torch_sharded_worker as W

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
WORLD_TIMEOUT = 240           # seconds, each world and the JAX subprocess
LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
B, S, STEPS = 4, 28, 6
CAPACITY = 4.0                # the all-to-all branch drops no copy

# name: (arch, moe_a2a)
ARCHS = {"granite": ("granite-3-2b", False),
         "mistral": ("mistral-large-123b", False),
         "llama4": ("llama4-scout-17b-a16e", True),
         "grok": ("grok-1-314b", False),
         "rg": ("recurrentgemma-2b", False)}
MESHES = {"2x4": (2, 4), "4x2": (4, 2)}
# each arch with fsdp on and off and with caches of 32 and 30 slots on
# each mesh: (mesh, arch, cache_len, fsdp)
RUNS = [(m, a, cl, fsdp) for m in MESHES for a in ARCHS
        for cl, fsdp in (((32, True), (30, False)) if m == "2x4"
                         else ((32, False), (30, True)))]
# the runs the JAX package also runs sharded (compiling dominates its
# time): one a mesh and arch, so each arch with FSDP on and off, both
# cache lengths and the three layouts (granite and llama4 at 30 on (2, 4)
# by heads, recurrentgemma there whole, the rest over the sequence)
JAX_SHARDED_RUNS = [r for r in RUNS
                    if (r[2] == 30) == (r[1] in ("granite", "llama4", "rg"))]


def _run_name(run):
    return "{}-{}-c{}-{}".format(run[0], run[1], run[2],
                                 "fsdp" if run[3] else "nofsdp")


class _JaxMeshShape:
    """What the reference's ``spec_for`` reads of a mesh: names and a
    device array's shape."""

    def __init__(self, shape, axes=("data", "model")):
        self.axis_names = axes
        self.devices = np.empty(shape)


def _jax_spec_leaves(specs):
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JSpec))[0]
    return {"/".join(p.key for p in path): s for path, s in flat}


def _save(tree, path):
    np.savez(path, **{p: a for p, a in iter_leaves(bridge.to_numpy(tree))})
    return str(path)


JAX_SHARDED = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_config, list_archs
from repro.models import model as M, sharding as S
import repro.models.blocks as BL

args = json.load(open(sys.argv[1]))
BL.MOE_A2A_CAPACITY_FACTOR = args["capacity"]

def tree(path):
    out = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            *head, last = key.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = jnp.asarray(z[key])
    return out

res = {}
for run in args["runs"]:
    cfg = get_config(run["arch"]).reduced()
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(run["mesh"]), ("data", "model"))
    rules = S.rules_for("serve", fsdp=run["fsdp"], moe_a2a=run["a2a"])
    p_shard = S.param_shardings(M.param_specs(cfg), rules, mesh)
    tokens = jnp.asarray(run["tokens"])
    Bsz, Sq = tokens.shape
    c_shard = S.param_shardings(M.cache_specs(cfg, Bsz, run["cache_len"]), rules, mesh)

    def ruled(fn):
        def inner(*a):
            with S.axis_rules(mesh, rules):
                return fn(*a)
        return inner
    pre = jax.jit(ruled(lambda p, t: M.prefill(cfg, p, {"tokens": t},
                                               cache_len=run["cache_len"])),
                  in_shardings=(p_shard, None))
    dec = jax.jit(ruled(lambda p, c, t, pos: M.decode_step(cfg, p, c, t, pos)),
                  in_shardings=(p_shard, c_shard, None, None),
                  out_shardings=(None, c_shard))
    params = jax.device_put(tree(run["weights"]), p_shard)
    logits, cache = pre(params, tokens)
    cache = jax.device_put(cache, c_shard)
    outs = [np.asarray(logits)]
    pos = jnp.full((Bsz,), Sq, jnp.int32)
    for tok in run["steps"]:
        logits, cache = dec(params, cache, jnp.asarray(tok), pos)
        outs.append(np.asarray(logits))
        pos = pos + 1
    res[run["name"]] = np.stack(outs)

# the reference's serve_fsdp (importing the dry run after the devices are
# up leaves them as they are)
from repro.launch.dryrun import FSDP_SERVE_BYTES, Opts, serve_fsdp
fsdp = {a: bool(serve_fsdp(get_config(a), Opts())) for a in list_archs()}
np.savez(args["out"], **res)
json.dump({"FSDP_SERVE_BYTES": FSDP_SERVE_BYTES, "serve_fsdp": fsdp},
          open(args["out_json"], "w"))
print("ok")
"""


def _jax_one_device(arch, weights, tokens, steps, cache_len):
    """The JAX package's one-device prefill then decode steps (jitted):
    every step's logits (7, B, 1, V) and the final cache {path: array}."""
    cfg = get_config(arch).reduced()
    pre = jax.jit(lambda p, t: JM.prefill(cfg, p, {"tokens": t}, cache_len=cache_len))
    dec = jax.jit(lambda p, c, t, pos: JM.decode_step(cfg, p, c, t, pos))
    logits, cache = pre(weights, jnp.asarray(tokens))
    outs = [np.asarray(logits)]
    pos = jnp.full((tokens.shape[0],), tokens.shape[1], jnp.int32)
    for tok in steps:
        logits, cache = dec(weights, cache, jnp.asarray(tok), pos)
        outs.append(np.asarray(logits))
        pos = pos + 1
    flat = jax.tree_util.tree_flatten_with_path(jax.device_get(cache))[0]
    return np.stack(outs), {"/".join(p.key for p in path): np.asarray(v)
                            for path, v in flat}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Everything the checks read, in one pass: the weights and inputs of
    each arch (the same arrays for both packages), the JAX sharded runs
    started in a subprocess first, the JAX one-device runs meanwhile, then
    the port's two worlds, then the subprocess's results."""
    d = tmp_path_factory.mktemp("serve")
    inputs = {}
    for name, (arch, _) in ARCHS.items():
        cfg = get_config(arch).reduced()
        params = jax.device_get(JM.init_model_params(cfg, jax.random.PRNGKey(3)))
        rng = np.random.default_rng(len(name))
        inputs[name] = dict(
            params=params, weights=_save(bridge.from_jax(params, "cpu"), d / f"{name}.npz"),
            tokens=rng.integers(0, cfg.vocab, (B, S)),
            steps=[rng.integers(0, cfg.vocab, (B, 1)) for _ in range(STEPS)])
    args = dict(capacity=CAPACITY, out=str(d / "jax.npz"), out_json=str(d / "jax.json"),
                runs=[dict(name=_run_name(r), arch=ARCHS[r[1]][0], mesh=MESHES[r[0]],
                           cache_len=r[2], fsdp=r[3], a2a=ARCHS[r[1]][1],
                           weights=inputs[r[1]]["weights"],
                           tokens=inputs[r[1]]["tokens"].tolist(),
                           steps=[t.tolist() for t in inputs[r[1]]["steps"]])
                      for r in JAX_SHARDED_RUNS])
    (d / "args.json").write_text(json.dumps(args))
    # one XLA thread: the subprocess runs beside the worlds' 8 ranks
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(JAX_SHARDED),
                             str(d / "args.json")], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        one = {(name, cl): _jax_one_device(ARCHS[name][0], i["params"], i["tokens"],
                                           i["steps"], cl)
               for name, i in inputs.items() for cl in (30, 32)}
        worlds = {}
        for m, shape in MESHES.items():
            tasks = [dict(name=_run_name(r), kind="serve", arch=ARCHS[r[1]][0],
                          weights=inputs[r[1]]["weights"], tokens=inputs[r[1]]["tokens"],
                          steps=inputs[r[1]]["steps"], cache_len=r[2], fsdp=r[3],
                          a2a=ARCHS[r[1]][1], capacity=CAPACITY)
                     for r in RUNS if r[0] == m]
            if m == "4x2":
                tasks.append(dict(name="refusals", kind="serve_refusals",
                                  arch="granite-3-2b"))
            worlds.update(TMESH.run_world(
                W.run, int(np.prod(shape)), {"mesh": shape, "axes": ("data", "model"),
                                             "tasks": tasks},
                run_dir=d / f"world_{m}", backend="gloo", timeout_s=WORLD_TIMEOUT)[0])
        _, err = proc.communicate(timeout=WORLD_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    with np.load(d / "jax.npz") as z:
        sharded = {k: z[k] for k in z.files}
    return dict(inputs=inputs, one=one, worlds=worlds, sharded=sharded,
                ref=json.loads((d / "jax.json").read_text()))


@pytest.mark.parametrize("run", RUNS, ids=[_run_name(r) for r in RUNS])
def test_sharded_serving_matches_reference(served, run):
    """Prefill + 6 decode steps under the mesh: the logits of every step
    against the JAX package's one-device and sharded runs, the gathered
    cache after the last step against the one-device one, and every cache
    leaf's placements against the reference's ``spec_for``."""
    mesh, name, cache_len, fsdp = run
    got = served["worlds"][_run_name(run)]
    want, want_cache = served["one"][(name, cache_len)]
    err_one = float(np.abs(got["logits"] - want).max())
    errs = {"one-device": err_one}
    if run in JAX_SHARDED_RUNS:
        errs["sharded"] = float(np.abs(got["logits"] -
                                       served["sharded"][_run_name(run)]).max())
    print(_run_name(run), "max err against the JAX package's runs", errs)
    assert got["logits"].shape == (STEPS + 1, B, 1, want.shape[-1])
    assert max(errs.values()) <= LOGIT_TOL, errs
    assert got["cache"].keys() == want_cache.keys()
    for path, w in want_cache.items():
        err = float(np.abs(got["cache"][path] - w).max())
        assert err <= CACHE_TOL, (path, err)
    arch, a2a = ARCHS[name]
    rules = JS.rules_for("serve", fsdp=fsdp, moe_a2a=a2a)
    specs = _jax_spec_leaves(JM.cache_specs(get_config(arch).reduced(), B, cache_len))
    want_specs = {p: tuple(JS.spec_for(s.shape, s.axes, rules, _JaxMeshShape(MESHES[mesh])))
                  for p, s in specs.items()}
    assert got["specs"] == want_specs
    assert got["decode_specs"] == want_specs
    assert got["zero_placed"]      # init_sharded_cache, distribute_cache


@pytest.mark.parametrize("runs", ["all", "jax_sharded"])
def test_the_three_cache_layouts_are_driven(runs):
    """The runs, and those the JAX package also runs sharded, cover each
    arch with FSDP on and off and each layout spec_for gives a K/V leaf:
    split over its sequence, split by its KV heads, and whole."""
    chosen = RUNS if runs == "all" else JAX_SHARDED_RUNS
    for name in ARCHS:
        assert {r[3] for r in chosen if r[1] == name} == {True, False}, name
    seen = set()
    for mesh, name, cache_len, _ in chosen:
        cfg = get_config(ARCHS[name][0]).reduced()
        for path, s in _jax_spec_leaves(JM.cache_specs(cfg, B, cache_len)).items():
            if path.endswith("/k"):
                spec = tuple(JS.spec_for(s.shape, s.axes, JS.rules_for("serve"),
                                         _JaxMeshShape(MESHES[mesh]))) + (None,) * 4
                seen.add("seq" if spec[2] == "model" else
                         "heads" if spec[3] == "model" else "whole")
    assert seen == {"seq", "heads", "whole"}


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (1, 8), (2, 2, 2)])
@pytest.mark.parametrize("arch", [a for a in list_archs()
                                  if a not in ("tinyyolo-v2",)])
def test_cache_pspecs_equal_reference(arch, shape):
    """``sharding.cache_pspecs`` (and so ``cache_placements``,
    ``distribute_cache``, ``init_sharded_cache``) leaf for leaf against the
    reference's ``spec_for`` over its ``cache_specs``, registered widths,
    serve rules with and without FSDP."""
    axes = ("pod", "data", "model")[-len(shape):]
    for fsdp in (True, False):
        jr, tr = JS.rules_for("serve", fsdp=fsdp), TS.rules_for("serve", fsdp=fsdp)
        for Bsz, L in ((8, 4096), (3, 1030)):
            specs = _jax_spec_leaves(JM.cache_specs(get_config(arch), Bsz, L))
            want = {p: tuple(JS.spec_for(s.shape, s.axes, jr, _JaxMeshShape(shape, axes)))
                    for p, s in specs.items()}
            got = TS.cache_pspecs(tget_config(arch), Bsz, L, tr,
                                  TS.LogicalMesh(shape, axes))
            assert got == want, (arch, shape, fsdp, Bsz, L)


def test_serve_fsdp_equals_reference(served):
    """``sharding.serve_fsdp`` and ``FSDP_SERVE_BYTES`` against the
    reference's ``launch/dryrun.py`` (read in the JAX subprocess) for every
    registered arch."""
    ref = served["ref"]
    assert TS.FSDP_SERVE_BYTES == ref["FSDP_SERVE_BYTES"]
    for arch, want in ref["serve_fsdp"].items():
        assert TS.serve_fsdp(tget_config(arch)) == want, arch
    assert ref["serve_fsdp"]["mistral-large-123b"] and ref["serve_fsdp"]["grok-1-314b"]
    assert not ref["serve_fsdp"]["recurrentgemma-2b"]


REFUSALS = ("chunk", "paged", "mask", "int8_weights_train")


@pytest.mark.parametrize("case", REFUSALS)
def test_serving_refusals_on_a_mesh(served, case):
    """What the sharded path leaves out raises, never running unsharded in
    silence: chunk mode, a paged pool and the engine's decode row mask
    raise NotImplementedError naming ROADMAP; training with int8 weights
    raises the one-card path's TypeError. (int8 weights and caches in
    serving and MoE under the no_tp rules run: test_torch_sharded_quant.py.)"""
    msg = served["worlds"]["refusals"][case]
    want = "floating weights" if case == "int8_weights_train" else "ROADMAP Queue 1 H"
    assert msg and want in msg, (case, msg)


def test_cache_placements_follow_cache_pspecs():
    """With no process group: the placements ``cache_placements`` gives are
    one per mesh dim, Shard where ``cache_pspecs`` names the axis."""
    cfg = tget_config("recurrentgemma-2b").reduced()
    mesh = TS.LogicalMesh((2, 4), ("data", "model"))
    pls = TS.cache_placements(cfg, 4, 32, TS.rules_for("serve"), mesh)
    specs = TS.cache_pspecs(cfg, 4, 32, TS.rules_for("serve"), mesh)
    assert pls.keys() == specs.keys()
    for path, pl in pls.items():
        assert len(pl) == 2
        for name, p in zip(mesh.mesh_dim_names, pl):
            dims = [i for i, e in enumerate(specs[path]) if name in TS.spec_axes(e)]
            assert (p.is_shard() and [p.dim] == dims) or (p.is_replicate() and not dims)
    assert specs["blocks/p2/k"] == (None, "data", "model")
    assert specs["blocks/p0/h"] == (None, "data")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_parallel_rounds_once_and_passes_the_local_gradient(dtype):
    """``sharding.row_parallel``'s autograd Function on one rank (no axis to
    sum over): the product from float32 partials rounded once to x's
    dtype, and the local product's gradient, dx = dy w^T and dw = x^T dy,
    as autograd gives it for ``x @ w``; with no axes ``row_parallel`` is
    ``x @ w`` itself."""
    g = torch.Generator().manual_seed(0)
    dt = getattr(torch, dtype)
    x = torch.randn(3, 5, 16, generator=g).to(dt).requires_grad_()
    w = torch.randn(16, 8, generator=g).to(dt).requires_grad_()
    dy = torch.randn(3, 5, 8, generator=g).to(dt)
    out = TS._RowParallel.apply(x, w, ())
    assert out.dtype == dt
    assert torch.equal(out, (x.detach().float() @ w.detach().float()).to(dt))
    out.backward(dy)
    x2, w2 = (t.detach().clone().requires_grad_() for t in (x, w))
    (x2 @ w2).backward(dy)
    torch.testing.assert_close(x.grad, x2.grad)
    torch.testing.assert_close(w.grad, w2.grad)
    assert torch.equal(TS.row_parallel(x2, w2, None, ()), x2 @ w2)


def test_row_parallel_gradcheck():
    """The Function's backward against finite differences, float64."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 3, 6, generator=g, dtype=torch.float64, requires_grad=True)
    w = torch.randn(6, 4, generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a, b: TS._RowParallel.apply(a, b, ()),
                                    (x, w))
