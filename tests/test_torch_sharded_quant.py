"""What the sharded path refused until now, against the JAX package on the
CPU: int8 weights and int8 K/V caches in serving, and MoE layers under the
no_tp rules (the batch on every mesh axis) in serving and training.

The port runs in two worlds of 8 gloo ranks (``launch.mesh.run_world``;
the rank side is ``tests/torch_sharded_worker.py``, which imports no jax),
on (2, 4) and (4, 2) data x model meshes, each world running all its
cases in one spawn. Every arch runs at ``.reduced()`` widths in float32,
from the port's ``init_model_params`` (seed 3: the same weights in every
run), the same arrays on both sides.

Serving (a prefill of 28 tokens, then 6 decode steps at positions 28..33,
into caches of 32 and 30 slots, ``fsdp`` on and off):

* int8 weights (``narrow_weights``; grok-1's Megatron MoE and qwen2.5-14b's
  QKV biases, drawn non-zero as ``test_torch_quant.py`` draws them), B=4:
  every step's logits within ``LOGIT_TOL`` of the JAX package's, which
  upcasts every integer leaf; the gathered cache within ``CACHE_TOL``.
* int8 K/V caches: the prefill's K/V narrowed (the reference's ``astype``,
  the port's ``saturate_cast``), then the decode steps write int8 into
  them; granite cut to one attention layer (its cache split over its
  sequence at 32 slots, by KV heads at 30 on model 4) and recurrentgemma's
  local-attention rings (split over their sequence, or whole at 30 on
  model 4), ``wk`` / ``wv`` scaled by ``test_torch_quant.py``'s
  ``KV_SCALE`` so that K/V span int8's range. The logits within its
  ``KV_ATOL`` and the stored int8 values equal but for at most ``FLIPS``
  of them, each off by one (see that file's docstring: truncation flips a
  value within rounding of an integer).
* the no_tp rules, B=8 (one row a rank): grok-1 (4 experts top-2; the
  Megatron branch after the gather over ``model``), llama4-scout with the
  all-to-all rules at capacity 4 (its prefill takes the all-to-all branch
  on (2, 4), where its 4 experts match the model axis; the Megatron branch
  on (4, 2) and in decode) and granite (dense: nothing is sliced over
  ``model``).

Every run against the JAX package's one-device prefill / decode_step
(jitted, in this process) and one run a case (``JAX_SHARDED``) against its
own sharded run under the same rules, jitted on 8 host devices in a
subprocess started first and run beside the worlds, the caches placed as
``build_decode`` places them (int8 where the case narrows them); every
cache leaf's placements against the reference's ``spec_for`` (int8 leaves
placed as float ones).

Training: two grok-1 steps under ``rules_for("train", no_tp=True)``
(B=8 S=16, AdamW at lr 3e-4, eps 1e-6) on each mesh, the losses and every
gathered parameter within 1e-4 of the JAX package's own sharded steps
under the same rules, every replica of a shard equal bit for bit; and the
expert leaves' gradient placements the body declares: partial over the
data axes only (a Megatron expert slice's gradient comes from its data
shard's gathered rows; partial over ``model`` too would count it m
times).

Also, with no process group: the MoE branch ``blocks.layout`` picks under
each rule set and mesh, by the reference's conditions.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config
from repro.models import model as JM
from repro.models import sharding as JS
from repro.models.param import Spec as JSpec
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.launch import mesh as TMESH
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM
from repro_torch.models import sharding as TS
from repro_torch.models.param import iter_leaves, map_tree

import torch_sharded_worker as W
from test_torch_quant import FLIPS, KV_ATOL, KV_SCALE

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
WORLD_TIMEOUT = 240           # seconds, each world and the JAX subprocess
LOGIT_TOL = LOSS_TOL = PARAM_TOL = 1e-4
CACHE_TOL = 1e-5
S, STEPS = 28, 6
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 16, 2
OPT = dict(lr=3e-4, warmup_steps=1, total_steps=10, eps=1e-6)
CAPACITY = 4.0                # the all-to-all branch drops no copy

# name: (arch, config edits, what the case does, batch)
CASES = {
    "grok_w8": ("grok-1-314b", {}, dict(w8=True), 4),
    "qwen_w8": ("qwen2.5-14b", {}, dict(w8=True, biases=True), 4),
    "granite_kv8": ("granite-3-2b", dict(n_layers=1), dict(kv8=True), 4),
    "rg_kv8": ("recurrentgemma-2b", {}, dict(kv8=True), 4),
    "grok_notp": ("grok-1-314b", {}, dict(no_tp=True), 8),
    "llama4_notp": ("llama4-scout-17b-a16e", {}, dict(no_tp=True, a2a=True), 8),
    "granite_notp": ("granite-3-2b", {}, dict(no_tp=True), 8),
}
MESHES = {"2x4": (2, 4), "4x2": (4, 2)}
RUNS = [(m, c, cl, fsdp) for m in MESHES for c in CASES
        for cl, fsdp in (((32, True), (30, False)) if m == "2x4"
                         else ((32, False), (30, True)))]
# one run a case for the JAX package's sharded path: both meshes, both
# cache lengths and the three layouts of an int8 cache (granite at 30 on
# (2, 4) by heads, recurrentgemma there whole, at 32 over the sequence)
JAX_SHARDED = {"grok_w8": ("4x2", 32), "qwen_w8": ("2x4", 30),
               "granite_kv8": ("2x4", 30), "rg_kv8": ("2x4", 30),
               "grok_notp": ("2x4", 32), "llama4_notp": ("2x4", 30),
               "granite_notp": ("4x2", 30)}
JAX_SHARDED_RUNS = [r for r in RUNS if JAX_SHARDED[r[1]] == (r[0], r[2])]
TRAIN = ("grok-1-314b", "2x4"), ("grok-1-314b", "4x2")


def _run_name(run):
    return "{}-{}-c{}-{}".format(run[0], run[1], run[2], "fsdp" if run[3] else "nofsdp")


def _rules(module, case, fsdp):
    kw = CASES[case][2]
    return module.rules_for("serve", fsdp=fsdp, no_tp=kw.get("no_tp", False),
                            moe_a2a=kw.get("a2a", False))


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


def _jax_cfg(case):
    arch, over, _, _ = CASES[case]
    return dataclasses.replace(get_config(arch).reduced(), **over)


def _tcfg(case):
    arch, over, _, _ = CASES[case]
    return dataclasses.replace(tget_config(arch).reduced(), **over)


def _weights(case):
    """The case's numpy weights: the port's ``init_model_params`` (seed 3;
    its per-leaf seeds are stable across processes, where the reference's
    ``hash`` of a path is salted, so every run draws the same weights), cut
    to the case's layers; QKV biases drawn non-zero, ``wk`` / ``wv`` times
    ``KV_SCALE`` for an int8 cache, narrowed by the port for int8
    weights."""
    _, _, kw, _ = CASES[case]
    tree = bridge.to_numpy(TM.init_model_params(_tcfg(case), 3, "cpu"))
    rng = np.random.default_rng(7)

    def edit(path, a):
        name = path.split("/")[-1]
        if kw.get("biases") and name in ("bq", "bk", "bv"):
            a = (rng.standard_normal(a.shape) * 0.5).astype(a.dtype)
        if kw.get("kv8") and name in ("wk", "wv"):
            a = a * KV_SCALE
        return a
    tree = map_tree(edit, tree)
    if kw.get("w8"):
        tree = bridge.to_numpy(TM.narrow_weights(bridge.from_jax(tree, "cpu")))
    return tree


def _jax_narrow(cache):
    """The reference's narrowing of a prefill's cache for an int8 decode:
    the attention k, v leaves ``astype(int8)``."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: a.astype(jnp.int8) if path[-1].key in ("k", "v") else a, cache)


JAX_SUBPROCESS = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_config
from repro.models import model as M, sharding as S
import repro.models.blocks as BL
from repro.train import optimizer as O
from repro.train.train_loop import train_step

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

def narrow(cache):
    return jax.tree_util.tree_map_with_path(
        lambda path, a: a.astype(jnp.int8) if path[-1].key in ("k", "v") else a, cache)

def cfg_of(run):
    import dataclasses
    return dataclasses.replace(get_config(run["arch"]).reduced(), **run["over"])

res = {}
for run in args["serve"]:
    cfg = cfg_of(run)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(run["mesh"]), ("data", "model"))
    rules = S.rules_for("serve", fsdp=run["fsdp"], no_tp=run["no_tp"], moe_a2a=run["a2a"])
    p_shard = S.param_shardings(M.param_specs(cfg), rules, mesh)
    tokens = jnp.asarray(run["tokens"])
    Bsz, Sq = tokens.shape
    kv = "int8" if run["kv8"] else None
    c_shard = S.param_shardings(M.cache_specs(cfg, Bsz, run["cache_len"], kv_dtype=kv),
                                rules, mesh)

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
    if run["kv8"]:
        cache = narrow(cache)
    cache = jax.device_put(cache, c_shard)
    outs = [np.asarray(logits)]
    pos = jnp.full((Bsz,), Sq, jnp.int32)
    for tok in run["steps"]:
        logits, cache = dec(params, cache, jnp.asarray(tok), pos)
        outs.append(np.asarray(logits))
        pos = pos + 1
    res[run["name"]] = np.stack(outs)

for run in args["train"]:
    cfg = cfg_of(run)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(run["mesh"]), ("data", "model"))
    ocfg = O.AdamWConfig(**run["opt"])
    params = tree(run["weights"])
    state = O.init_opt_state(ocfg, params)
    losses = []
    with S.axis_rules(mesh, S.rules_for("train", no_tp=True)):
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


def _jax_one_device(case, weights, tokens, steps, cache_len):
    """The JAX package's one-device prefill then decode steps (jitted; an
    int8-cache case narrows the prefill's cache first): every step's
    logits (7, B, 1, V) and the final cache {path: array}."""
    cfg = _jax_cfg(case)
    pre = jax.jit(lambda p, t: JM.prefill(cfg, p, {"tokens": t}, cache_len=cache_len))
    dec = jax.jit(lambda p, c, t, pos: JM.decode_step(cfg, p, c, t, pos))
    logits, cache = pre(weights, jnp.asarray(tokens))
    if CASES[case][2].get("kv8"):
        cache = _jax_narrow(cache)
    outs = [np.asarray(logits)]
    pos = jnp.full((tokens.shape[0],), tokens.shape[1], jnp.int32)
    for tok in steps:
        logits, cache = dec(weights, cache, jnp.asarray(tok), pos)
        outs.append(np.asarray(logits))
        pos = pos + 1
    flat = jax.tree_util.tree_flatten_with_path(jax.device_get(cache))[0]
    return np.stack(outs), {"/".join(p.key for p in path): np.asarray(v)
                            for path, v in flat}


def _train_name(run):
    return "train-{}-{}".format(run[0], run[1])


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Everything the checks read, in one pass: each case's weights and
    inputs (the same arrays for both packages) and the training start and
    batches; the JAX sharded runs started in a subprocess first, the JAX
    one-device runs meanwhile, then the port's two worlds, then the
    subprocess's results."""
    d = tmp_path_factory.mktemp("quant")
    inputs = {}
    for i, (case, (arch, over, kw, Bsz)) in enumerate(CASES.items()):
        weights = _weights(case)
        vocab = _jax_cfg(case).vocab
        rng = np.random.default_rng(40 + i)
        inputs[case] = dict(
            params=jax.tree_util.tree_map(jnp.asarray, weights),
            weights=_save(bridge.from_jax(weights, "cpu"), d / f"{case}.npz"),
            tokens=rng.integers(0, vocab, (Bsz, S)),
            steps=[rng.integers(0, vocab, (Bsz, 1)) for _ in range(STEPS)])
    train = {}
    for arch, m in TRAIN:
        cfg = get_config(arch).reduced()
        rng = np.random.default_rng(50)
        init = TM.init_model_params(tget_config(arch).reduced(), 5, "cpu")
        train[(arch, m)] = dict(
            weights=_save(init, d / f"train_{m}.npz"),
            batches=[{k: rng.integers(0, cfg.vocab, (TRAIN_B, TRAIN_S))
                      for k in ("tokens", "labels")} for _ in range(TRAIN_STEPS)])

    def serve_args(r):
        arch, over, kw, _ = CASES[r[1]]
        i = inputs[r[1]]
        return dict(name=_run_name(r), arch=arch, over=over, mesh=MESHES[r[0]],
                    cache_len=r[2], fsdp=r[3], no_tp=kw.get("no_tp", False),
                    a2a=kw.get("a2a", False), kv8=kw.get("kv8", False),
                    weights=i["weights"], tokens=i["tokens"].tolist(),
                    steps=[t.tolist() for t in i["steps"]])
    args = dict(capacity=CAPACITY, out=str(d / "jax.npz"),
                serve=[serve_args(r) for r in JAX_SHARDED_RUNS],
                train=[dict(name=_train_name(t), arch=t[0], over={}, mesh=MESHES[t[1]],
                            opt=OPT, weights=train[t]["weights"],
                            batches=[{k: v.tolist() for k, v in b.items()}
                                     for b in train[t]["batches"]]) for t in TRAIN])
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
        one = {(case, cl): _jax_one_device(case, i["params"], i["tokens"], i["steps"], cl)
               for case, i in inputs.items() for cl in (30, 32)}
        out = {}
        for m, shape in MESHES.items():
            tasks = []
            for r in RUNS:
                if r[0] != m:
                    continue
                arch, over, kw, _ = CASES[r[1]]
                i = inputs[r[1]]
                tasks.append(dict(
                    name=_run_name(r), kind="serve", arch=arch, over=over,
                    weights=i["weights"], tokens=i["tokens"], steps=i["steps"],
                    cache_len=r[2], fsdp=r[3], no_tp=kw.get("no_tp", False),
                    a2a=kw.get("a2a", False), capacity=CAPACITY,
                    kv_dtype="int8" if kw.get("kv8") else None))
            tasks += [dict(name=_train_name(t), kind="train_rules", arch=t[0], opt=OPT,
                           rules=dict(no_tp=True), weights=train[t]["weights"],
                           batches=train[t]["batches"]) for t in TRAIN if t[1] == m]
            out.update(TMESH.run_world(
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
    return dict(one=one, worlds=out, sharded=sharded)


def _same_store(got, want, what):
    """The int8 values stored on the two sides: equal but for at most
    ``FLIPS`` of them, each off by one."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= FLIPS, \
        f"{what}: {int((diff > 0).sum())} of {diff.size} differ, by up to {diff.max()}"


@pytest.mark.parametrize("run", RUNS, ids=[_run_name(r) for r in RUNS])
def test_sharded_serving_matches_reference(worlds, run):
    """Prefill + 6 decode steps under the mesh: every step's logits against
    the JAX package's one-device run (and its sharded run, for the case's
    ``JAX_SHARDED`` run), the gathered cache after the last step against
    the one-device one (int8 leaves: ``_same_store``), every cache leaf's
    placements against the reference's ``spec_for``, and the zero caches
    ``init_sharded_cache`` and ``distribute_cache`` make placed alike and
    in the dtype the run's cache has."""
    mesh, case, cache_len, fsdp = run
    kv8 = CASES[case][2].get("kv8", False)
    tol = KV_ATOL if kv8 else LOGIT_TOL
    got = worlds["worlds"][_run_name(run)]
    want, want_cache = worlds["one"][(case, cache_len)]
    errs = {"one-device": float(np.abs(got["logits"] - want).max())}
    if run in JAX_SHARDED_RUNS:
        errs["sharded"] = float(np.abs(got["logits"] -
                                       worlds["sharded"][_run_name(run)]).max())
    print(_run_name(run), "max err against the JAX package's runs", errs)
    assert got["logits"].shape == (STEPS + 1, CASES[case][3], 1, want.shape[-1])
    assert max(errs.values()) <= tol, errs
    assert got["cache"].keys() == want_cache.keys()
    narrowed = 0
    for path, w in want_cache.items():
        g = got["cache"][path]
        if w.dtype == np.int8:
            assert g.dtype == np.int8, path
            _same_store(g, w, path)
            assert (np.abs(g.astype(np.int32)) >= 127).any(), f"{path}: nothing saturates"
            narrowed += 1
        else:
            err = float(np.abs(g - w).max())
            assert err <= CACHE_TOL, (path, err)
    assert narrowed == (2 if kv8 else 0)
    specs = _jax_spec_leaves(JM.cache_specs(_jax_cfg(case), CASES[case][3], cache_len))
    want_specs = {p: tuple(JS.spec_for(s.shape, s.axes, _rules(JS, case, fsdp),
                                       _JaxMeshShape(MESHES[mesh])))
                  for p, s in specs.items()}
    assert got["specs"] == want_specs
    assert got["decode_specs"] == want_specs
    assert got["zero_placed"]


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][2].get("kv8")])
def test_int8_caches_take_the_three_layouts(case):
    """The int8-cache runs place their attention K/V split over the
    sequence, by KV heads (granite at 30 slots on model 4) and whole
    (recurrentgemma's ring at 30 slots on model 4: one KV head), as the
    reference's ``spec_for`` does."""
    seen = set()
    for mesh, c, cache_len, fsdp in RUNS:
        if c != case:
            continue
        for path, s in _jax_spec_leaves(JM.cache_specs(_jax_cfg(c), CASES[c][3],
                                                       cache_len)).items():
            if path.endswith("/k"):
                spec = tuple(JS.spec_for(s.shape, s.axes, _rules(JS, c, fsdp),
                                         _JaxMeshShape(MESHES[mesh]))) + (None,) * 4
                i = 1 if path.startswith("blocks/") else 0
                seen.add("seq" if spec[i + 1] == "model" else
                         "heads" if spec[i + 2] == "model" else "whole")
    assert seen == {"seq", "heads" if case == "granite_kv8" else "whole"}


@pytest.mark.parametrize("run", TRAIN, ids=[_train_name(t) for t in TRAIN])
def test_no_tp_moe_train_steps_match_reference(worlds, run):
    """Two grok-1 steps under the no_tp rules (the Megatron MoE branch
    after the gather over ``model``): the losses and every gathered
    parameter against the JAX package's own sharded steps under the same
    rules; every replica of a shard equal bit for bit."""
    t = worlds["worlds"][_train_name(run)]
    sharded = worlds["sharded"]
    want = list(sharded[_train_name(run) + "/losses"])
    pre = _train_name(run) + "/final/"
    final = {k[len(pre):]: v for k, v in sharded.items() if k.startswith(pre)}
    got = dict(iter_leaves(t["final"]))
    assert got.keys() == final.keys()
    errs = {p: float(np.abs(np.asarray(got[p], np.float32) - w).max())
            for p, w in final.items()}
    worst = max(errs, key=errs.get)
    print(_train_name(run), "losses", t["losses"], "reference", want, "worst leaf", worst,
          errs[worst], "replicas", t["replica_spread"])
    np.testing.assert_allclose(t["losses"], want, atol=LOSS_TOL)
    assert errs[worst] <= PARAM_TOL, (worst, errs[worst])
    assert t["replica_spread"] == 0.0


@pytest.mark.parametrize("run", TRAIN, ids=[_train_name(t) for t in TRAIN])
def test_no_tp_moe_gradient_placements(worlds, run):
    """The Megatron expert slices' gradients under the no_tp rules: sliced
    over ``model`` (``we_g``/``we_u`` columns, ``we_d`` rows), partial over
    ``data`` only; the router's partial over ``data`` and replicated over
    ``model``."""
    t = worlds["worlds"][_train_name(run)]
    assert (t["moe"], t["gather"]) == ("megatron", True)
    assert t["grad_placements"] == {"router": ["P(sum)", "R"], "we_g": ["P(sum)", "S(2)"],
                                    "we_u": ["P(sum)", "S(2)"], "we_d": ["P(sum)", "S(1)"]}


# the MoE branch by the reference's conditions (``repro/models/blocks.py``
# ``moe_ffn``): (rules, mesh, B, S, arch) -> (branch, gathers over model)
BRANCHES = [
    (dict(no_tp=True), (2, 4), 8, 28, "grok-1-314b", ("megatron", True)),
    (dict(no_tp=True), (4, 2), 8, 1, "grok-1-314b", ("megatron", True)),
    (dict(no_tp=True, moe_a2a=True), (2, 4), 8, 28, "llama4-scout-17b-a16e", ("a2a", True)),
    (dict(no_tp=True, moe_a2a=True), (2, 4), 8, 1, "llama4-scout-17b-a16e",
     ("megatron", True)),
    (dict(no_tp=True, moe_a2a=True), (4, 2), 8, 28, "llama4-scout-17b-a16e",
     ("megatron", True)),
    (dict(no_tp=True), (1, 8), 8, 28, "grok-1-314b", ("local", False)),
    (dict(no_tp=True), (2, 4), 4, 28, "grok-1-314b", ("megatron", False)),
    (dict(no_tp=True), (2, 4), 3, 28, "grok-1-314b", ("local", False)),
    ({}, (2, 4), 8, 28, "grok-1-314b", ("megatron", False)),
]


@pytest.mark.parametrize("rules,shape,Bsz,Sq,arch,want", BRANCHES)
def test_moe_branch_follows_reference(rules, shape, Bsz, Sq, arch, want):
    """``blocks.layout`` on a logical mesh: the reference's branch (local
    where the data axes do not divide B, Megatron where ``model`` divides
    d_ff, all-to-all where the rules ask, S > 1, ``model`` divides S and E
    equals its size), and a gather over ``model`` exactly where the batch
    spans it and a branch that takes a data shard's rows runs."""
    cfg = tget_config(arch).reduced()
    mesh = TS.LogicalMesh(shape, ("data", "model"))
    plan = TS.make_plan(mesh, TS.rules_for("serve", **rules), Bsz)
    lay = TB.layout(cfg, {"router": None}, plan, Bsz, Sq)
    assert (lay.moe, lay.gather) == want
