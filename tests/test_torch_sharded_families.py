"""The families whose layers are not attention, and the inputs that are not
plain tokens, under a (data, model) mesh against the JAX package, on the
CPU: xLSTM (sLSTM and mLSTM blocks), whisper's encoder-decoder (frames),
llava's patch prefix and recurrentgemma's RG-LRU, in training and serving.

The port runs in two worlds of 8 gloo ranks (``launch.mesh.run_world``;
the rank side is ``tests/torch_sharded_worker.py``, which imports no jax),
on (2, 4) and (4, 2) data x model meshes, each world running all its
cases in one spawn. Every arch runs at ``.reduced()`` widths in float32.

Serving (xlstm-350m, whisper-tiny with frames, llava-next-34b with
patches; ``fsdp`` on and off): a prefill of B=4 (28 positions: 28 tokens,
or 16 patches and 12 tokens), then 6 decode steps at positions 28..33,
which cross the wrap of every cache of 30 or 32 slots. 32 slots split the
self-attention K/V over their sequence on either mesh; 30 split them by
KV heads on model 4 and over the sequence on model 2; whisper's cross K/V
are split by KV heads (4 over model 2 or 4), never over their frames.
Every step's logits within 1e-4 of the JAX package's one-device
``prefill`` / ``decode_step``, the gathered caches after the last step
within 1e-5 of its cache (times the leaf's largest |value| where that
passes 1), every cache leaf's placements equal to the
reference's ``spec_for`` over ``cache_specs``.

Training (the four archs, recurrentgemma's RG-LRU among them): three
``make_train_step(cfg, opt, mesh)`` steps from ``init_sharded`` (whose
gathered tree equals ``init_model_params``), B=8 S=16, AdamW at lr 3e-4
and eps 1e-6 (``OPT``): losses and every gathered parameter within 1e-4 of
the JAX package's one-device ``train_step`` from the same weights, and
every rank's copy of a
replicated shard equal bit for bit to the others'.

The JAX package's own sharded runs, one a family (``JAX_SHARDED``), run in
one subprocess with 8 host devices, started first and run beside the
worlds: the port's logits (serving) or losses and parameters (training)
within 1e-4 of them.

One check on one process: the sLSTM's input-gate bias has an exact
gradient of zero, the premise on which ``chip_smoke.py``'s phase 14 reads
those elements apart from its update ratio.
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

from repro.configs import get_config
from repro.models import model as JM
from repro.models import sharding as JS
from repro.models.param import Spec as JSpec
from repro.train import optimizer as JO
from repro.train.train_loop import train_step as jtrain_step
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.launch import mesh as TMESH
from repro_torch.models import model as TM
from repro_torch.models.param import iter_leaves
from repro_torch.train.train_loop import loss_and_grads

import torch_sharded_worker as W

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
WORLD_TIMEOUT = 240           # seconds, each world and the JAX subprocess
LOGIT_TOL = LOSS_TOL = PARAM_TOL = 1e-4
CACHE_TOL = 1e-5
B, S, STEPS = 4, 28, 6        # serving: 28 positions, then 6 decode steps
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 16, 3
# eps 1e-6: a fresh AdamW state's first update is lr * g / (|g| + eps), so
# at the default eps 1e-8 a gradient near zero that the two packages round
# ~1e-7 apart (a different order of the same sums) moves its parameter up
# to lr = 3e-4 apart; at 1e-6 that is at most lr * 1e-7 / 1e-6 = 3e-5
OPT = dict(lr=3e-4, warmup_steps=1, total_steps=10, eps=1e-6)

ARCHS = {"xlstm": "xlstm-350m", "whisper": "whisper-tiny",
         "llava": "llava-next-34b", "rg": "recurrentgemma-2b"}
SERVED = ("xlstm", "whisper", "llava")     # recurrentgemma's serving: PR 29's file
MESHES = {"2x4": (2, 4), "4x2": (4, 2)}
# serving: each arch with fsdp on and off and caches of 32 and 30 slots on
# each mesh: (mesh, arch, cache_len, fsdp)
SERVE_RUNS = [(m, a, cl, fsdp) for m in MESHES for a in SERVED
              for cl, fsdp in (((32, True), (30, False)) if m == "2x4"
                               else ((32, False), (30, True)))]
TRAIN_RUNS = [(m, a) for m in MESHES for a in ARCHS]
# the runs the JAX package also runs sharded: one a family
JAX_SHARDED = {"xlstm": ("serve", ("2x4", "xlstm", 32, True)),
               "whisper": ("serve", ("2x4", "whisper", 30, False)),
               "llava": ("serve", ("4x2", "llava", 30, True)),
               "rg": ("train", ("4x2", "rg"))}


def _serve_name(run):
    return "serve-{}-{}-c{}-{}".format(run[0], run[1], run[2],
                                       "fsdp" if run[3] else "nofsdp")


def _train_name(run):
    return "train-{}-{}".format(*run)


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


def _extras(name, cfg, n, rng):
    """A whisper batch's stub frames, a llava batch's stub patches."""
    if name == "whisper":
        return {"frames": rng.standard_normal((n, cfg.n_frames, cfg.d_model))
                .astype(np.float32)}
    if name == "llava":
        return {"patches": rng.standard_normal((n, cfg.n_patches, cfg.d_model))
                .astype(np.float32)}
    return {}


JAX_SUBPROCESS = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_config
from repro.models import model as M, sharding as S
from repro.train import optimizer as O
from repro.train.train_loop import train_step

args = json.load(open(sys.argv[1]))

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
for run in args["serve"]:
    cfg = get_config(run["arch"]).reduced()
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(run["mesh"]), ("data", "model"))
    rules = S.rules_for("serve", fsdp=run["fsdp"])
    p_shard = S.param_shardings(M.param_specs(cfg), rules, mesh)
    batch = {k: jnp.asarray(v) for k, v in run["batch"].items()}
    Bsz = batch["tokens"].shape[0]
    c_shard = S.param_shardings(M.cache_specs(cfg, Bsz, run["cache_len"]), rules, mesh)

    def ruled(fn):
        def inner(*a):
            with S.axis_rules(mesh, rules):
                return fn(*a)
        return inner
    pre = jax.jit(ruled(lambda p, b: M.prefill(cfg, p, b, cache_len=run["cache_len"])),
                  in_shardings=(p_shard, None))
    dec = jax.jit(ruled(lambda p, c, t, pos: M.decode_step(cfg, p, c, t, pos)),
                  in_shardings=(p_shard, c_shard, None, None),
                  out_shardings=(None, c_shard))
    params = jax.device_put(tree(run["weights"]), p_shard)
    logits, cache = pre(params, batch)
    cache = jax.device_put(cache, c_shard)
    outs = [np.asarray(logits)]
    pos = jnp.full((Bsz,), run["start"], jnp.int32)
    for tok in run["steps"]:
        logits, cache = dec(params, cache, jnp.asarray(tok), pos)
        outs.append(np.asarray(logits))
        pos = pos + 1
    res[run["name"]] = np.stack(outs)

for run in args["train"]:
    cfg = get_config(run["arch"]).reduced()
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(run["mesh"]), ("data", "model"))
    ocfg = O.AdamWConfig(**run["opt"])
    params = tree(run["weights"])
    state = O.init_opt_state(ocfg, params)
    losses = []
    with S.axis_rules(mesh, S.rules_for("train")):
        step = jax.jit(lambda p, o, b: train_step(cfg, ocfg, p, o, b, remat=True))
        for b in run["batches"]:
            params, state, m = step(params, state, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
    res[run["name"] + "/losses"] = np.asarray(losses)
    flat = jax.tree_util.tree_flatten_with_path(jax.device_get(params))[0]
    for path, v in flat:
        res[run["name"] + "/final/" + "/".join(p.key for p in path)] = np.asarray(v, np.float32)
np.savez(args["out"], **res)
print("ok")
"""


def _jax_serve(arch, weights, batch, steps, cache_len, start):
    """The JAX package's one-device prefill then decode steps (jitted):
    every step's logits (7, B, 1, V) and the final cache {path: array}."""
    cfg = get_config(arch).reduced()
    pre = jax.jit(lambda p, b: JM.prefill(cfg, p, b, cache_len=cache_len))
    dec = jax.jit(lambda p, c, t, pos: JM.decode_step(cfg, p, c, t, pos))
    logits, cache = pre(weights, {k: jnp.asarray(v) for k, v in batch.items()})
    outs = [np.asarray(logits)]
    pos = jnp.full((B,), start, jnp.int32)
    for tok in steps:
        logits, cache = dec(weights, cache, jnp.asarray(tok), pos)
        outs.append(np.asarray(logits))
        pos = pos + 1
    flat = jax.tree_util.tree_flatten_with_path(jax.device_get(cache))[0]
    return np.stack(outs), {"/".join(p.key for p in path): np.asarray(v)
                            for path, v in flat}


def _jax_train(arch, init, batches):
    """The JAX package's one-device ``train_step`` (jitted) from ``init``:
    (losses, {path: final parameter})."""
    cfg = get_config(arch).reduced()
    ocfg = JO.AdamWConfig(**OPT)
    params = jax.tree.map(jnp.asarray, init)
    state = JO.init_opt_state(ocfg, params)
    step = jax.jit(lambda p, o, b: jtrain_step(cfg, ocfg, p, o, b, remat=True))
    losses = []
    for b in batches:
        params, state, m = step(params, state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, dict(iter_leaves(jax.device_get(params)))


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    """Everything the checks read, in one pass: each arch's serving
    weights (JAX-drawn) and inputs, and its training start
    (``init_model_params(cfg, 0)``, what ``init_sharded`` draws) and
    batches, the same arrays for both packages; the JAX sharded runs
    started in a subprocess first, the JAX one-device runs meanwhile, then
    the port's two worlds, then the subprocess's results."""
    d = tmp_path_factory.mktemp("families")
    inputs = {}
    for i, (name, arch) in enumerate(ARCHS.items()):
        cfg, tcfg = get_config(arch).reduced(), tget_config(arch).reduced()
        rng = np.random.default_rng(30 + i)
        params = jax.device_get(JM.init_model_params(cfg, jax.random.PRNGKey(3)))
        n_tok = S - (cfg.n_patches if name == "llava" else 0)
        init_t = TM.init_model_params(tcfg, 0, "cpu")
        init = bridge.to_numpy(init_t)
        inputs[name] = dict(
            params=params, weights=_save(bridge.from_jax(params, "cpu"), d / f"{name}.npz"),
            batch={"tokens": rng.integers(0, cfg.vocab, (B, n_tok)),
                   **_extras(name, cfg, B, rng)},
            steps=[rng.integers(0, cfg.vocab, (B, 1)) for _ in range(STEPS)],
            init=init, init_weights=_save(init_t, d / f"{name}_init.npz"),
            batches=[{"tokens": rng.integers(0, cfg.vocab, (TRAIN_B, TRAIN_S)),
                      "labels": rng.integers(0, cfg.vocab, (TRAIN_B, TRAIN_S)),
                      **_extras(name, cfg, TRAIN_B, rng)} for _ in range(TRAIN_STEPS)])

    def listed(batch):
        return {k: v.tolist() for k, v in batch.items()}
    args = dict(out=str(d / "jax.npz"), serve=[], train=[])
    for name, (kind, run) in JAX_SHARDED.items():
        i = inputs[name]
        if kind == "serve":
            args["serve"].append(dict(
                name=_serve_name(run), arch=ARCHS[name], mesh=MESHES[run[0]],
                cache_len=run[2], fsdp=run[3], weights=i["weights"], batch=listed(i["batch"]),
                start=S, steps=[t.tolist() for t in i["steps"]]))
        else:
            args["train"].append(dict(
                name=_train_name(run), arch=ARCHS[name], mesh=MESHES[run[0]], opt=OPT,
                weights=i["init_weights"], batches=[listed(b) for b in i["batches"]]))
    (d / "args.json").write_text(json.dumps(args))
    # one XLA thread: the subprocess runs beside the worlds' 8 ranks
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(JAX_SUBPROCESS),
                             str(d / "args.json")], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        one = {(name, cl): _jax_serve(ARCHS[name], inputs[name]["params"],
                                      inputs[name]["batch"], inputs[name]["steps"], cl, S)
               for name in SERVED for cl in (30, 32)}
        trained = {name: _jax_train(arch, inputs[name]["init"], inputs[name]["batches"])
                   for name, arch in ARCHS.items()}
        worlds = {}
        for m, shape in MESHES.items():
            tasks = [dict(name=_serve_name(r), kind="serve", arch=ARCHS[r[1]],
                          weights=inputs[r[1]]["weights"], tokens=inputs[r[1]]["batch"]["tokens"],
                          **{k: v for k, v in inputs[r[1]]["batch"].items() if k != "tokens"},
                          steps=inputs[r[1]]["steps"], cache_len=r[2], fsdp=r[3])
                     for r in SERVE_RUNS if r[0] == m]
            tasks += [dict(name=_train_name(r), kind="train", arch=ARCHS[r[1]], seed=0,
                           opt=OPT, batches=inputs[r[1]]["batches"])
                      for r in TRAIN_RUNS if r[0] == m]
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
    return dict(inputs=inputs, one=one, trained=trained, worlds=worlds, sharded=sharded)


@pytest.mark.parametrize("run", SERVE_RUNS, ids=[_serve_name(r) for r in SERVE_RUNS])
def test_sharded_serving_matches_reference(families, run):
    """Prefill (with frames or patches) + 6 decode steps under the mesh:
    every step's logits against the JAX package's one-device run (and its
    sharded run, for the family's ``JAX_SHARDED`` run), the gathered cache
    after the last step against the one-device one, and every cache leaf's
    placements against the reference's ``spec_for``."""
    mesh, name, cache_len, fsdp = run
    got = families["worlds"][_serve_name(run)]
    want, want_cache = families["one"][(name, cache_len)]
    errs = {"one-device": float(np.abs(got["logits"] - want).max())}
    if JAX_SHARDED[name] == ("serve", run):
        errs["sharded"] = float(np.abs(got["logits"] -
                                       families["sharded"][_serve_name(run)]).max())
    print(_serve_name(run), "max err against the JAX package's runs", errs)
    assert got["logits"].shape == (STEPS + 1, B, 1, want.shape[-1])
    assert max(errs.values()) <= LOGIT_TOL, errs
    assert got["cache"].keys() == want_cache.keys()
    for path, w in want_cache.items():
        # relative to the leaf's scale where it passes 1: the sLSTM's
        # normaliser n sums its input gates over the tokens
        err = float(np.abs(got["cache"][path] - w).max())
        scale = max(1.0, float(np.abs(w).max()))
        assert err <= CACHE_TOL * scale, (path, err, scale)
    rules = JS.rules_for("serve", fsdp=fsdp)
    specs = _jax_spec_leaves(JM.cache_specs(get_config(ARCHS[name]).reduced(), B, cache_len))
    want_specs = {p: tuple(JS.spec_for(s.shape, s.axes, rules, _JaxMeshShape(MESHES[mesh])))
                  for p, s in specs.items()}
    assert got["specs"] == want_specs
    assert got["decode_specs"] == want_specs
    assert got["zero_placed"]      # init_sharded_cache, distribute_cache


@pytest.mark.parametrize("run", TRAIN_RUNS, ids=[_train_name(r) for r in TRAIN_RUNS])
def test_sharded_training_matches_reference(families, run):
    """Three ``make_train_step(cfg, opt, mesh)`` steps from ``init_sharded``
    (gathered: ``init_model_params(cfg, 0)`` bit for bit, each rank holding
    a shard): losses and every gathered parameter against the JAX package's
    one-device ``train_step`` (and its sharded one, for the family's
    ``JAX_SHARDED`` run); every replica of a shard equal bit for bit."""
    mesh, name = run
    t = families["worlds"][_train_name(run)]
    init = families["inputs"][name]["init"]
    got_init = dict(iter_leaves(t["init"]))
    assert got_init.keys() == dict(iter_leaves(init)).keys()
    for path, w in iter_leaves(init):
        assert np.array_equal(got_init[path], w), path
    assert t["local_is_shard"]
    refs = {"one-device": families["trained"][name]}
    if JAX_SHARDED[name] == ("train", run):
        pre = _train_name(run) + "/final/"
        sharded = families["sharded"]
        refs["sharded"] = (list(sharded[_train_name(run) + "/losses"]),
                           {k[len(pre):]: v for k, v in sharded.items() if k.startswith(pre)})
    final = dict(iter_leaves(t["final"]))
    for what, (losses, params) in refs.items():
        errs = {p: float(np.abs(np.asarray(final[p], np.float32) -
                                np.asarray(w, np.float32)).max()) for p, w in params.items()}
        worst = max(errs, key=errs.get)
        print(_train_name(run), what, "losses", t["losses"], "reference", losses,
              "worst leaf", worst, errs[worst])
        np.testing.assert_allclose(t["losses"], losses, atol=LOSS_TOL)
        assert final.keys() == params.keys()
        assert errs[worst] <= PARAM_TOL, (what, worst, errs[worst])
    print(_train_name(run), "largest difference between replicas", t["replica_spread"])
    assert t["replica_spread"] == 0.0


def test_the_cache_layouts_are_driven():
    """The serving runs split whisper's and llava's self-attention K/V over
    their sequence and by their KV heads, whisper's cross K/V by their KV
    heads (never over their frames) on both meshes, and xLSTM's state over
    the batch only, with FSDP on and off for each arch."""
    seen = set()
    for mesh, name, cache_len, fsdp in SERVE_RUNS:
        cfg = get_config(ARCHS[name]).reduced()
        rules = JS.rules_for("serve", fsdp=fsdp)
        for path, s in _jax_spec_leaves(JM.cache_specs(cfg, B, cache_len)).items():
            spec = tuple(JS.spec_for(s.shape, s.axes, rules,
                                     _JaxMeshShape(MESHES[mesh]))) + (None,) * 5
            leaf = path.split("/")[-1]
            i = 1 if path.startswith("blocks/") else 0    # the stacked layer axis
            if leaf in ("k", "v", "c_k", "c_v"):
                where = ("seq" if spec[i + 1] == "model" else
                         "heads" if spec[i + 2] == "model" else "whole")
                seen.add((name, "cross" if leaf.startswith("c_") else "self", where))
            else:
                assert "model" not in spec and spec[i] == "data", (path, spec)
    assert {("whisper", "self", "seq"), ("whisper", "self", "heads"),
            ("llava", "self", "seq"), ("llava", "self", "heads"),
            ("whisper", "cross", "heads")} <= seen
    assert not any(s[1] == "cross" and s[2] != "heads" for s in seen)
    for name in SERVED:
        assert {r[3] for r in SERVE_RUNS if r[1] == name} == {True, False}


def test_slstm_input_gate_bias_gradient_is_zero():
    """The input-gate quarter of the sLSTM's gate bias, which
    ``chip_smoke.py``'s phase 14 reads apart from its update ratio
    (``p14_noise``), has an exact gradient of zero (a constant added to
    every input gate scales c and n alike, and h = o c / n), so a fresh
    AdamW step moves it by rounding noise: in the port's float32 gradient
    (xlstm-350m ``.reduced()``, B=4 S=16) it is below 1e-6 of the largest
    |gradient| of the forget-gate quarter beside it."""
    cfg = tget_config("xlstm-350m").reduced()
    rng = np.random.default_rng(9)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16)))
             for k in ("tokens", "labels")}
    _, grads = loss_and_grads(cfg, TM.init_model_params(cfg, 0, "cpu"), batch,
                              remat=False)
    hd = cfg.d_model // cfg.n_heads
    gates = [g.reshape(-1, 4, hd) for p, g in iter_leaves(grads)
             if p.endswith("/b_gates")]
    assert gates
    for g in gates:                 # (heads, z i f o, hd)
        ratio = float(g[:, 1].abs().max() / g[:, 2].abs().max())
        print("input-gate bias |gradient| over the forget gate's", ratio)
        assert ratio <= 1e-6, ratio
