"""The port's sharded paths (``repro_torch.models.sharding``,
``launch.mesh``, the Megatron and all-to-all MoE branches, the sharded
train step) against the JAX package, on the CPU.

The port runs in worlds of ``torch.distributed`` ranks over gloo
(``launch.mesh.run_world``: spawned processes, a ``FileStore`` in the
test's temporary directory, one thread each, a timeout each), on the rank
side in ``tests/torch_sharded_worker.py``, which imports no jax. Weights
travel to the ranks as ``.npz`` files made through ``repro_torch.bridge``.
The JAX side runs in this process on its one CPU device; where a check
needs the JAX package's own sharded path (the all-to-all branch at its
default capacity, which drops copies; the Megatron MoE train step, whose
aux loss is a per-shard mean; llama4-scout top-1 and grok-1 top-2),
it runs in a subprocess with
``--xla_force_host_platform_device_count=8``, as ``test_distributed.py``
does.

Tolerances: the twins of ``test_distributed.py`` hold the sharded output
within 1e-3 of the one-device one (the reference's bound; the measured
error is printed); the sharded train steps hold losses within 1e-4 and
every parameter within 1e-4 after three steps at lr 3e-4 from a fresh
AdamW state (the first step's update is ``sign(g)``-like, so an element
whose gradient is near ``eps`` moves by up to lr on a float32 rounding),
and every rank's copy of a replicated shard equal bit for bit to the
others' after the steps (a gradient that differs across the ranks that
replicate a leaf makes them drift apart).
"""
import dataclasses
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
from repro.models import yolo as JY
from repro.models.param import Spec as JSpec
from repro.train import optimizer as JO
from repro.train.train_loop import train_step as jtrain_step
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.launch import mesh as TMESH
from repro_torch.models import model as TM
from repro_torch.models import sharding as TS
from repro_torch.models import yolo as TY
from repro_torch.models.param import iter_leaves

import torch_sharded_worker as W

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
WORLD_TIMEOUT = 240           # seconds, each world
TWIN_TOL = 1e-3               # the reference's bound
LOSS_TOL = PARAM_TOL = 1e-4
OPT = dict(lr=3e-4, warmup_steps=1, total_steps=10)

RULE_SETS = {
    "train": dict(kind="train"),
    "serve_nofsdp": dict(kind="serve", fsdp=False),
    "train_notp": dict(kind="train", no_tp=True),
    "train_a2a": dict(kind="train", moe_a2a=True),
}
MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((4, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]


class _JaxMeshShape:
    """What the reference's ``spec_for`` reads of a mesh: names and a
    device array's shape."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.empty(shape)


def _spec_trees(arch):
    if arch == "tinyyolo-v2":
        return JY.yolo_specs(), TY.yolo_specs()
    return (JM.param_specs(get_config(arch).reduced()),
            TM.param_specs(tget_config(arch).reduced()),
            JM.param_specs(get_config(arch)), TM.param_specs(tget_config(arch)))


def _jax_leaves(specs):
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JSpec))[0]
    return {"/".join(p.key for p in path): s for path, s in flat}


# ----------------------------------------------------------------------
# rule parity: pure Python, no process group
# ----------------------------------------------------------------------
@pytest.mark.parametrize("rules", sorted(RULE_SETS))
@pytest.mark.parametrize("arch", list_archs())
def test_spec_for_and_axes_equal_reference(arch, rules):
    kw = RULE_SETS[rules]
    jr, tr = JS.rules_for(**kw), TS.rules_for(**kw)
    assert jr == tr
    trees = _spec_trees(arch)
    for jspecs, tspecs in zip(trees[::2], trees[1::2]):
        want, got = _jax_leaves(jspecs), dict(iter_leaves(tspecs))
        assert want.keys() == got.keys()
        for path, js in want.items():
            assert (js.shape, js.axes) == (got[path].shape, got[path].axes), path
        for shape, axes in MESHES:
            jmesh = _JaxMeshShape(shape, axes)
            tmesh = TS.LogicalMesh(shape, axes)
            for path, js in want.items():
                assert tuple(JS.spec_for(js.shape, js.axes, jr, jmesh)) == \
                    TS.spec_for(js.shape, js.axes, tr, tmesh), (path, shape)
            pspecs = dict(iter_leaves(TS.param_pspecs(tspecs, tr, tmesh)))
            jps = JS.param_pspecs(jspecs, jr, jmesh)
            for path, p in _jax_leaves_p(jps).items():
                assert tuple(p) == pspecs[path], (path, shape)


def _jax_leaves_p(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(p.key for p in path): s for path, s in flat}


# ----------------------------------------------------------------------
# units with no process group
# ----------------------------------------------------------------------
def test_constrain_is_a_no_op_outside_rules_and_on_one_rank():
    x = torch.randn(4, 8, 16)
    assert TS.constrain(x, "batch", "seq", "embed") is x
    host = TMESH.make_host_mesh()
    assert (host.shape, host.mesh_dim_names) == ((1, 1), ("data", "model"))
    assert TMESH.mesh_chips(host) == 1
    with TS.axis_rules(host, TS.rules_for("train")):
        assert TS.current_rules()[0] is host
        assert TS.constrain(x, "batch", "seq", "embed") is x
        assert TS.shard_activation(x, ("batch", None, None),
                                   TS.rules_for("train"), host) is x
    assert TS.current_rules() is None
    # a one-rank shape with no process group needs none
    assert TMESH.make_mesh((1, 1), ("data", "model"), device="cpu").shape == (1, 1)


def test_make_mesh_raises_without_the_ranks_it_needs(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="needs 8 ranks"):
        TMESH.make_mesh((2, 4), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="one name per mesh dim"):
        TMESH.make_mesh((2, 4), ("data",), device="cpu")


def test_one_rank_mesh_runs_the_one_card_step():
    """The launcher's host mesh: make_train_step with it is the one-card
    step (same loss and parameters as with no mesh)."""
    from repro_torch.train import optimizer as TO
    from repro_torch.train.train_loop import make_train_step
    cfg = tget_config("granite-3-2b").reduced()
    batch = {k: np.random.default_rng(0).integers(0, cfg.vocab, (2, 8))
             for k in ("tokens", "labels")}
    outs = []
    for mesh in (None, TMESH.make_host_mesh()):
        params = TM.init_model_params(cfg, 0, "cpu")
        ocfg = TO.AdamWConfig(**OPT)
        step = make_train_step(cfg, ocfg, mesh, device="cpu")
        params, _, m = step(params, TO.init_opt_state(ocfg, params), batch)
        outs.append((float(m["loss"]), params))
    assert outs[0][0] == outs[1][0]
    for (p, a), (_, b) in zip(iter_leaves(outs[0][1]), iter_leaves(outs[1][1])):
        assert torch.equal(a, b), p


# ----------------------------------------------------------------------
# the worlds
# ----------------------------------------------------------------------
def _save(tree, path):
    np.savez(path, **{p: a for p, a in iter_leaves(bridge.to_numpy(tree))})
    return str(path)


def _jax_params(arch, over, seed=0):
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    return cfg, jax.device_get(JM.init_model_params(cfg, jax.random.PRNGKey(seed)))


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape)


A2A = ("llama4-scout-17b-a16e", dict(n_experts=4, top_k=1))
GROK = ("grok-1-314b", {})
KV_SPLIT = ("granite-3-2b", dict(n_kv_heads=2))
GRANITE = ("granite-3-2b", {})
LLAMA4 = ("llama4-scout-17b-a16e", {})


def _batches(vocab, n, B, S, seed):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, vocab, (B, S)),
             "labels": rng.integers(0, vocab, (B, S))} for _ in range(n)]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Weights (.npz, through the bridge), tokens and batches of every
    check; the same arrays feed both packages."""
    d = tmp_path_factory.mktemp("inputs")
    out = {}
    for name, (arch, over) in dict(a2a=A2A, grok=GROK, kv=KV_SPLIT,
                                   granite=GRANITE).items():
        cfg, params = _jax_params(arch, over)
        out[name] = dict(cfg=cfg, params=params,
                         weights=_save(bridge.from_jax(params, "cpu"),
                                       d / f"{name}.npz"))
    out["a2a"]["tokens"] = _tokens(512, (4, 32), 1)
    out["grok"]["tokens"] = _tokens(512, (4, 16), 1)
    for name in ("kv", "granite"):
        out[name]["tokens"] = _tokens(512, (8, 16), 1)
        out[name]["labels"] = _tokens(512, (8, 16), 2)
    out["notp_tokens"] = _tokens(512, (4, 16), 6)
    out["train_granite"] = _batches(512, 3, 8, 16, 3)
    out["train_llama4"] = _batches(512, 3, 4, 16, 4)
    out["train_grok"] = _batches(512, 3, 4, 16, 5)
    return out


def _task(name, kind, arch_over, **kw):
    return dict(name=name, kind=kind, arch=arch_over[0], over=arch_over[1], **kw)


def _world(tmp, name, shape, tasks):
    n = int(np.prod(shape))
    return TMESH.run_world(W.run, n, {"mesh": shape, "axes": ("data", "model"),
                                      "tasks": tasks},
                           run_dir=tmp / name, backend="gloo",
                           timeout_s=WORLD_TIMEOUT)[0]


@pytest.fixture(scope="module")
def world_2x4(inputs, tmp_path_factory):
    i = inputs
    tasks = [
        _task("a2a_cf4", "forward", A2A, weights=i["a2a"]["weights"],
              tokens=i["a2a"]["tokens"], rules=dict(moe_a2a=True), capacity=4.0),
        _task("a2a_cf125", "forward", A2A, weights=i["a2a"]["weights"],
              tokens=i["a2a"]["tokens"], rules=dict(moe_a2a=True), capacity=1.25),
        _task("megatron", "forward", GROK, weights=i["grok"]["weights"],
              tokens=i["grok"]["tokens"]),
        _task("kv_split", "loss", KV_SPLIT, weights=i["kv"]["weights"],
              tokens=i["kv"]["tokens"], labels=i["kv"]["labels"]),
    ]
    return _world(tmp_path_factory.mktemp("w"), "2x4", (2, 4), tasks)


@pytest.fixture(scope="module")
def world_4x2(inputs, tmp_path_factory):
    i = inputs
    tasks = [
        _task("loss", "loss", GRANITE, weights=i["granite"]["weights"],
              tokens=i["granite"]["tokens"], labels=i["granite"]["labels"]),
        _task("loss_notp", "loss", GRANITE, weights=i["granite"]["weights"],
              tokens=i["granite"]["tokens"], labels=i["granite"]["labels"],
              rules=dict(no_tp=True)),
        _task("train", "train", GRANITE, seed=0, opt=OPT,
              batches=i["train_granite"]),
    ]
    return _world(tmp_path_factory.mktemp("w"), "4x2", (4, 2), tasks)


@pytest.fixture(scope="module")
def world_2x2(inputs, tmp_path_factory):
    b, g = inputs["train_llama4"], inputs["train_granite"]
    tasks = [
        _task("train", "train", LLAMA4, seed=0, opt=OPT, batches=b),
        _task("grok_train", "train", GROK, seed=0, opt=OPT,
              batches=inputs["train_grok"]),
        _task("g_remat", "train", GRANITE, seed=0, opt=OPT, batches=g),
        _task("g_noremat", "train", GRANITE, seed=0, opt=OPT, batches=g,
              remat=False),
        _task("g_dots", "train", GRANITE, seed=0, opt=OPT, batches=g,
              remat_policy="dots"),
        _task("refusals", "refusals", GRANITE, family_arch=LLAMA4[0],
              family_rules=dict(no_tp=True), family_tokens=inputs["notp_tokens"]),
    ]
    return _world(tmp_path_factory.mktemp("w"), "2x2", (2, 2), tasks)


JAX_SHARDED = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_config
from repro.models import model as M, sharding as S
import repro.models.blocks as BL
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

def cfg_of(arch, over):
    import dataclasses
    return dataclasses.replace(get_config(arch).reduced(), **over)

res = {}
a = args["a2a"]
cfg = cfg_of(a["arch"], a["over"])
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
BL.MOE_A2A_CAPACITY_FACTOR = 1.25
with S.axis_rules(mesh, S.rules_for("train", moe_a2a=True)):
    got, _, _ = jax.jit(lambda p, t: M.forward(cfg, p, {"tokens": t},
                        mode="train"))(tree(a["weights"]), jnp.asarray(a["tokens"]))
res["a2a_logits"] = np.asarray(got)

mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
for name, t in args["train"].items():
    cfg = cfg_of(t["arch"], t["over"])
    ocfg = O.AdamWConfig(**t["opt"])
    params = tree(t["weights"])
    state = O.init_opt_state(ocfg, params)
    losses = []
    with S.axis_rules(mesh, S.rules_for("train")):
        step = jax.jit(lambda p, o, b: train_step(cfg, ocfg, p, o, b, remat=True))
        for b in t["batches"]:
            params, state, m = step(params, state,
                                    {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
    res[name + "/losses"] = np.asarray(losses)
    flat = jax.tree_util.tree_flatten_with_path(jax.device_get(params))[0]
    for path, v in flat:
        res[name + "/final/" + "/".join(p.key for p in path)] = \
            np.asarray(v, np.float32)
np.savez(args["out"], **res)
print("ok")
"""


@pytest.fixture(scope="module")
def jax_sharded(inputs, world_2x2, tmp_path_factory):
    """The JAX package's own sharded a2a forward at capacity 1.25 on (2, 4)
    and its Megatron MoE train steps on (2, 2) (llama4-scout top-1, grok-1
    top-2), in a subprocess with 8 host devices, from the same weights as
    the port's."""
    import json
    d = tmp_path_factory.mktemp("jax_sharded")
    train = {}
    for task, (arch, over), batches in (("train", LLAMA4, "train_llama4"),
                                        ("grok_train", GROK, "train_grok")):
        init = world_2x2[task]["init"]
        train[task] = dict(
            arch=arch, over=over, opt=OPT,
            weights=_save(bridge.from_jax(init, "cpu"), d / f"{task}.npz"),
            batches=[{k: v.tolist() for k, v in b.items()}
                     for b in inputs[batches]])
    args = dict(
        a2a=dict(arch=A2A[0], over=A2A[1], weights=inputs["a2a"]["weights"],
                 tokens=inputs["a2a"]["tokens"].tolist()),
        train=train, out=str(d / "out.npz"))
    (d / "args.json").write_text(json.dumps(args))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_SHARDED),
                          str(d / "args.json")], env=env, capture_output=True,
                         text=True, timeout=WORLD_TIMEOUT)
    assert run.returncode == 0, run.stderr[-3000:]
    with np.load(d / "out.npz") as z:
        return {k: z[k] for k in z.files}


def _jax_logits(cfg, params, tokens):
    logits, _, _ = JM.forward(cfg, params, {"tokens": jnp.asarray(tokens)},
                              mode="train")
    return np.asarray(logits, np.float32)


def test_moe_a2a_matches_local_routing(inputs, world_2x4):
    """llama4-scout .reduced() with 4 experts top-1 on (2, 4), the a2a
    rules and capacity factor 4 (no drops): the port's sharded forward
    against the JAX package's one-device forward."""
    i = inputs["a2a"]
    err = float(np.abs(world_2x4["a2a_cf4"]["logits"] -
                       _jax_logits(i["cfg"], i["params"], i["tokens"])).max())
    print("a2a cf 4.0 max err", err)
    assert err < TWIN_TOL, err


def test_moe_a2a_with_drops_matches_reference_sharded(inputs, world_2x4,
                                                      jax_sharded):
    """The same at the default capacity factor 1.25, where copies drop:
    against the JAX package's own sharded all-to-all forward."""
    got = world_2x4["a2a_cf125"]["logits"]
    want = jax_sharded["a2a_logits"]
    local = _jax_logits(inputs["a2a"]["cfg"], inputs["a2a"]["params"],
                        inputs["a2a"]["tokens"])
    err = float(np.abs(got - want).max())
    print("a2a cf 1.25 max err against the reference's sharded path", err,
          "; against local routing", float(np.abs(got - local).max()))
    assert err < 1e-4, err
    assert float(np.abs(got - local).max()) > 1e-3   # copies were dropped


def test_megatron_moe_matches_local_routing(inputs, world_2x4):
    """grok-1 .reduced() (4 experts top-2) on (2, 4), train rules: the
    Megatron body against the JAX package's one-device forward."""
    i = inputs["grok"]
    err = float(np.abs(world_2x4["megatron"]["logits"] -
                       _jax_logits(i["cfg"], i["params"], i["tokens"])).max())
    print("megatron max err", err)
    assert err < TWIN_TOL, err


def _jax_loss(entry):
    batch = {"tokens": jnp.asarray(entry["tokens"]),
             "labels": jnp.asarray(entry["labels"])}
    return float(JM.loss_fn(entry["cfg"], entry["params"], batch))


def test_sharded_train_step_matches_single_device(inputs, world_4x2):
    """granite .reduced() on (4, 2): the sharded loss_fn against the JAX
    package's one-device loss_fn."""
    want, got = _jax_loss(inputs["granite"]), world_4x2["loss"]
    print("granite (4, 2) loss", got, "reference", want)
    assert abs(got - want) < TWIN_TOL


def test_no_tp_rules_loss_matches_single_device(inputs, world_4x2):
    """granite .reduced() on (4, 2) under ``rules_for("train", no_tp=True)``:
    the batch spans every axis, so no axis slices heads, d_ff or the vocab
    (the embedding and the cross-entropy take their whole-vocab branches);
    the loss against the JAX package's one-device loss_fn."""
    want, got = _jax_loss(inputs["granite"]), world_4x2["loss_notp"]
    print("granite (4, 2) no_tp loss", got, "reference", want)
    assert abs(got - want) < TWIN_TOL


def test_kv_head_split_mesh_matches_single_device(inputs, world_2x4):
    """granite .reduced() with 2 KV heads on model 4: spec_for splits the
    KV columns mid-head (KV*hd = 128 over 4), so each rank takes the KV
    head its query heads read; the loss against the one-device one."""
    i = inputs["kv"]
    wk = TS.spec_for((256, 128), ("embed", "kv"), TS.rules_for("train"),
                     TS.LogicalMesh((2, 4), ("data", "model")))
    assert wk == ("data", "model")            # a half head a rank
    want, got = _jax_loss(i), world_2x4["kv_split"]
    print("kv split loss", got, "reference", want)
    assert abs(got - want) < TWIN_TOL


def _jax_steps(arch, over, init, batches, remat=True):
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    ocfg = JO.AdamWConfig(**OPT)
    params = jax.tree.map(jnp.asarray, init)
    state = JO.init_opt_state(ocfg, params)
    step = jax.jit(lambda p, o, b: jtrain_step(cfg, ocfg, p, o, b, remat=remat))
    losses = []
    for b in batches:
        params, state, m = step(params, state,
                                {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, dict(iter_leaves(jax.device_get(params)))


def _held(got, want, tol, what):
    for path, w in want.items():
        err = float(np.abs(np.asarray(got[path], np.float32) -
                           np.asarray(w, np.float32)).max())
        assert err <= tol, f"{what} {path}: {err} > {tol}"


def _held_against_sharded_reference(task, world_2x2, jax_sharded, inputs,
                                     arch_over, batches, what):
    """A Megatron MoE train task's losses and parameters against the JAX
    package's own sharded step (within 1e-4), and its first loss against
    the one-device step's (within 2e-3: the aux loss is each data shard's,
    pmean'd, not the one-device aux of all tokens; 0.01 x an aux
    difference of up to 0.2; later steps drift apart as the two aux
    gradients move the weights differently)."""
    t = world_2x2[task]
    want = jax_sharded[task + "/losses"]
    print(what, "losses", t["losses"], "reference sharded", want)
    np.testing.assert_allclose(t["losses"], want, atol=LOSS_TOL)
    pre = task + "/final/"
    final = {k[len(pre):]: v for k, v in jax_sharded.items() if k.startswith(pre)}
    assert final.keys() == dict(iter_leaves(t["final"])).keys()
    _held(dict(iter_leaves(t["final"])), final, PARAM_TOL, what)
    one, _ = _jax_steps(*arch_over, t["init"], inputs[batches])
    print("reference one-device", one)
    assert abs(t["losses"][0] - one[0]) < 2e-3


def test_init_sharded_gathers_to_init_model_params(world_4x2, world_2x2):
    for world, (arch, over) in ((world_4x2, GRANITE), (world_2x2, LLAMA4)):
        cfg = dataclasses.replace(tget_config(arch).reduced(), **over)
        want = dict(iter_leaves(bridge.to_numpy(TM.init_model_params(cfg, 0, "cpu"))))
        got = dict(iter_leaves(world["train"]["init"]))
        assert got.keys() == want.keys()
        for path, w in want.items():
            assert np.array_equal(got[path], w), (arch, path)
        assert world["train"]["local_is_shard"]


def test_three_sharded_train_steps_granite(inputs, world_4x2):
    """make_train_step(cfg, opt, mesh) from init_sharded, granite .reduced()
    on (4, 2): losses and gathered parameters against the JAX package's
    one-device train_step on the same weights and batches."""
    t = world_4x2["train"]
    losses, final = _jax_steps(*GRANITE, t["init"], inputs["train_granite"])
    print("granite losses", t["losses"], "reference", losses)
    np.testing.assert_allclose(t["losses"], losses, atol=LOSS_TOL)
    _held(dict(iter_leaves(t["final"])), final, PARAM_TOL, "granite")


def test_three_sharded_train_steps_megatron_moe(inputs, world_2x2,
                                               jax_sharded):
    """llama4-scout .reduced() (Megatron MoE, 4 experts top-1) on (2, 2):
    against the JAX package's own sharded step and, for its first loss,
    the one-device step (``_held_against_sharded_reference``)."""
    _held_against_sharded_reference("train", world_2x2, jax_sharded, inputs,
                                    LLAMA4, "train_llama4", "llama4")


def test_three_sharded_train_steps_megatron_moe_top2(inputs, world_2x2,
                                                    jax_sharded):
    """grok-1 .reduced() (Megatron MoE, 4 experts top-2) on (2, 2): with
    two experts a token the routing weights are not 1, so the router's
    gradient flows through them (top-1's is zero): against the JAX
    package's own sharded step and, for its first loss, the one-device
    step (``_held_against_sharded_reference``)."""
    assert inputs["grok"]["cfg"].top_k == 2
    _held_against_sharded_reference("grok_train", world_2x2, jax_sharded,
                                    inputs, GROK, "train_grok", "grok-1")


@pytest.mark.parametrize("world,task", [
    ("world_4x2", "train"), ("world_2x2", "train"), ("world_2x2", "grok_train"),
    ("world_2x2", "g_noremat")])
def test_replicated_leaves_agree_across_ranks(request, world, task):
    """After the sharded steps, every rank's copy of a replicated shard
    (over ``data`` or ``model``) equals the other ranks' bit for bit: each
    replicated leaf's gradient is whole and the same on every rank that
    holds it."""
    spread = request.getfixturevalue(world)[task]["replica_spread"]
    print(world, task, "largest difference between replicas", spread)
    assert spread == 0.0, spread


def test_remat_and_dots_give_the_same_sharded_step(inputs, world_2x2):
    """granite .reduced() (two periods, each checkpointed) on (2, 2):
    remat=True (the default policy), remat=False and remat_policy="dots"
    give the same losses and parameters bit for bit; and the dots policy
    saves as many products a rank as in one process (the local_map bodies
    run the same plain products on local shards)."""
    from repro_torch.train import optimizer as TO
    from repro_torch.train.train_loop import train_step
    cfg = dataclasses.replace(tget_config(GRANITE[0]).reduced(), **GRANITE[1])
    with W.count_saved_dots() as saved:
        params = TM.init_model_params(cfg, 0, "cpu")
        ocfg = TO.AdamWConfig(**OPT)
        state = TO.init_opt_state(ocfg, params)
        for b in inputs["train_granite"]:
            params, state, _ = train_step(cfg, ocfg, params, state, b,
                                          remat=True, remat_policy="dots")
    got = world_2x2["g_dots"]["dots_saved"]
    print("dots saved a rank", got, "one process", saved[0])
    assert saved[0] > 0 and got == saved[0], (got, saved[0])
    base = world_2x2["g_remat"]
    for other in ("g_noremat", "g_dots"):
        o = world_2x2[other]
        assert o["losses"] == base["losses"], other
        for (p, a), (_, b) in zip(iter_leaves(base["final"]),
                                  iter_leaves(o["final"])):
            assert np.array_equal(a, b), (other, p)


def test_no_tp_moe_forward_matches_single_device(inputs, world_2x2):
    """llama4-scout .reduced() (Megatron MoE, 4 experts top-1) on (2, 2)
    under ``rules_for("train", no_tp=True)``: the batch spans the model
    axis, so the MoE layer gathers its data shard's rows over ``model``
    first (``blocks.layout``'s ``gather``); the logits against the JAX
    package's one-device forward of the same weights."""
    cfg = tget_config(LLAMA4[0]).reduced()
    params = bridge.to_numpy(TM.init_model_params(cfg, 0, "cpu"))
    want = _jax_logits(get_config(LLAMA4[0]).reduced(),
                       jax.tree.map(jnp.asarray, params), inputs["notp_tokens"])
    err = float(np.abs(world_2x2["refusals"]["family"] - want).max())
    print("llama4 (2, 2) no_tp max err", err)
    assert err < TWIN_TOL, err


def test_refusals_on_a_mesh(world_2x2):
    """A DTensor handed to a kernel wrapper raises TypeError; a mesh that
    needs more ranks than the world has raises ValueError."""
    r = world_2x2["refusals"]
    for name, msg in r["kernels"].items():
        assert msg and "local tensors" in msg, (name, msg)
    assert r["mesh"] and "needs 8 ranks" in r["mesh"], r
