"""The port's dry run (``repro_torch/launch/dryrun.py``) against the JAX
package's (``repro/launch/dryrun.py``), on the CPU.

One JAX subprocess (importing ``repro.launch.dryrun`` forces 512 host
devices on its process) is started first and runs beside the port's
cases: for each combination of ``COMBOS`` (full width, cut in depth) it
lowers and compiles the reference's step for ``memory_analysis()`` and
runs its cost probes (``_probe_cost``); it also gives the reference's
decisions (``variant_for``, ``SKIPS``, ``serve_fsdp``) for every arch x
shape, its constants and its ``Opts`` fields. The port traces the same
combinations on fake tensors over a fake process group of 256 or 512
ranks, in this process.

Checks: the argument bytes a device equal the reference's
``argument_size_in_bytes`` exactly (a train step's counter, a host int in
the port, at the reference's 4 bytes); the FLOPs a chip against the
reference's probe FLOPs within ``COMBOS``' band (measured, then stated
with their cause there); the decisions equal; each kernel wrapper's
shape-only path (fake outputs of the plain version's shapes and dtypes,
FLOPs and bytes by the reckoning of ``PERF.md``'s bound column, nothing
built, no launch counted); ``StepCounter`` against a hand-reckoned count
of collectives on a fake (2, 4) mesh; the CLI at full width in a
subprocess (the twin of ``test_dryrun_single_combo_subprocess``);
``step_time`` and ``roofline_profile`` read from a sweep ``run_combo``
wrote.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.base import input_specs
from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_gmm as gm
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as rs
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline import collectives as C
from repro_torch.serve import service_model as SM

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
TIMEOUT = 300                 # seconds, the JAX subprocess and the CLI

# (arch, shape, mesh, layers, opts, FLOPs a chip port / reference: low,
# high) at every width as published. The bands hold the ratios measured on
# this code (in brackets) and their causes: XLA's cost analysis counts
# elementwise work (norms, rope, softmax, int8 converts) that the flop
# counter does not, so a decode step reads lower; the port's layout adds
# products: each model rank computes all KV heads again for its range of a
# sequence-split prefill cache (granite: 8 KV heads, model 16), attention
# computes replicated over model where the heads do not divide it (llama4:
# 40 heads on 16; GSPMD pads them to 48 and splits them), and a train step
# recomputes each period's forward in its backward (remat) eagerly.
COMBOS = [
    ("granite-3-2b", "decode_32k", "single", 2, {}, 0.92, 1.00),       # [0.968]
    ("granite-3-2b", "prefill_32k", "single", 2, {}, 1.25, 1.37),      # [1.312]
    ("granite-3-2b", "train_4k", "single", 2, {}, 1.06, 1.18),         # [1.118]
    ("llama4-scout-17b-a16e", "prefill_32k", "single", 4, {}, 8.6, 9.6),  # [9.08]
    ("recurrentgemma-2b", "decode_32k", "single", 3, {}, 0.99, 1.10),  # [1.044]
    ("mistral-large-123b", "prefill_32k", "multi", 2, {}, 1.28, 1.42),  # [1.349]
    ("grok-1-314b", "decode_32k", "single", 2,
     {"weight_dtype": "int8", "cache_dtype": "int8"}, 0.55, 0.62),     # [0.581]
    # a batch the model axis does not divide under the no_tp rules, and a
    # batch of 1 with FSDP weights: the residual stream's d, sharded by a
    # constrain site, gathered before each layer (the two refused before
    # PR 33). Under no_tp the port still slices heads and d_ff over model
    # where the batch leaves it free (Plan.model); the reference computes
    # every head on each model rank
    ("grok-1-314b", "decode_32k", "single", 2, {"no_tp": True}, 0.17, 0.20),  # [0.184]
    ("llama4-scout-17b-a16e", "long_500k", "single", 4, {"fsdp_serve": True},
     3.6, 4.2),                                                          # [3.885]
]


def _combo_id(c) -> str:
    return f"{c[0]}-{c[1]}-{c[2]}-{c[3]}L" + "".join(f"-{k}={v}" for k, v in c[4].items())


JAX_REF = """
import dataclasses, json, sys
args = json.load(open(sys.argv[1]))
from repro.launch import dryrun as D          # 512 host devices
from repro.configs.base import SHAPES, get_config, list_archs
from repro.launch.mesh import make_production_mesh
from repro.roofline.hlo import COLLECTIVES

out = {"combos": [], "variants": {}, "serve_fsdp": {}}
for arch, shape, mesh_name, layers, opts in args["combos"]:
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    shp = SHAPES[shape]
    mesh = make_production_mesh(multi_pod=mesh_name == "multi")
    o = D.Opts(**opts)
    fn, fargs = D.BUILDERS[shp.kind](cfg, shp, mesh, o)
    ma = fn.lower(*fargs).compile().memory_analysis()
    cost = D._probe_cost(cfg, shp, mesh, o)
    out["combos"].append({"arg": int(ma.argument_size_in_bytes),
                          "flops": float(cost["flops"])})
for arch in list_archs():
    cfg = get_config(arch)
    for name, shp in SHAPES.items():
        v = D.variant_for(cfg, shp)
        out["variants"][arch + "/" + name] = None if v is None else \\
            [v.name, [k.value for k in v.pattern], v.window]
    out["serve_fsdp"][arch] = [bool(D.serve_fsdp(cfg, D.Opts(fsdp_serve=f)))
                               for f in (None, True, False)]
out["skips"] = [[a, s, r] for (a, s), r in sorted(D.SKIPS.items())]
out["constants"] = [D.LONG_CONTEXT_WINDOW, D.FSDP_SERVE_BYTES, list(COLLECTIVES)]
out["opts"] = [[f.name, f.default] for f in dataclasses.fields(D.Opts)]
json.dump(out, open(args["out"], "w"))
"""


def _fresh_fake_group(n: int):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


@pytest.fixture(scope="module", autouse=True)
def _no_group_left():
    """This module's fake process groups end with it (the worker's next
    test file starts with none)."""
    yield
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _trace(arch, shape_name, mesh_name, layers, opts):
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=mesh_name == "multi", device="cpu")
    with D.fake_mode():
        step, args = D.BUILDERS[shape.kind](cfg, shape, mesh, D.Opts(**opts), "cpu")
        return D.trace(step, args, D.STEP_COUNTER_BYTES if shape.kind == "train" else 0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference, port): the JAX subprocess started first, the port's
    traces meanwhile, then the subprocess's results."""
    d = tmp_path_factory.mktemp("dryrun")
    (d / "args.json").write_text(json.dumps(dict(
        out=str(d / "ref.json"), combos=[list(c[:5]) for c in COMBOS])))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(JAX_REF),
                             str(d / "args.json")], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        port = {_combo_id(c): _trace(*c[:5]) for c in COMBOS}
        _, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    reference = json.loads((d / "ref.json").read_text())
    reference["by_combo"] = {_combo_id(c): r for c, r in zip(COMBOS, reference["combos"])}
    return reference, port


@pytest.mark.parametrize("combo", COMBOS, ids=_combo_id)
def test_argument_bytes_equal_the_reference(runs, combo):
    reference, port = runs
    key = _combo_id(combo)
    assert port[key]["argument_bytes"] == reference["by_combo"][key]["arg"]


@pytest.mark.parametrize("combo", COMBOS, ids=_combo_id)
def test_flops_within_the_stated_band(runs, combo):
    reference, port = runs
    key = _combo_id(combo)
    ratio = port[key]["flops"] / reference["by_combo"][key]["flops"]
    assert combo[5] <= ratio <= combo[6], ratio


@pytest.mark.parametrize("arch", [a for a in list_archs()])
def test_decisions_equal_the_reference(runs, arch):
    reference, _ = runs
    cfg = get_config(arch)
    for name, shape in SHAPES.items():
        v = D.variant_for(cfg, shape)
        got = None if v is None else [v.name, [k.value for k in v.pattern], v.window]
        assert got == reference["variants"][f"{arch}/{name}"], name
    assert [D.serve_fsdp(cfg, D.Opts(fsdp_serve=f)) for f in (None, True, False)] == \
        reference["serve_fsdp"][arch]


def test_skips_constants_and_opts_equal_the_reference(runs):
    reference, _ = runs
    assert [[a, s, r] for (a, s), r in sorted(D.SKIPS.items())] == reference["skips"]
    assert [D.LONG_CONTEXT_WINDOW, D.FSDP_SERVE_BYTES, list(C.COLLECTIVES)] == \
        reference["constants"]
    # the same fields and defaults; impl None (the card's path) where the
    # reference lowers "xla"
    want = [[n, None if n == "impl" else v] for n, v in reference["opts"]]
    assert [[f.name, f.default] for f in dataclasses.fields(D.Opts)] == want


def test_a_field_the_port_cannot_honour_raises():
    for kind, opts, name in (("train", D.Opts(weight_dtype="int8"), "weight_dtype"),
                             ("train", D.Opts(fsdp_serve=True), "fsdp_serve"),
                             ("prefill", D.Opts(cache_dtype="int8"), "cache_dtype"),
                             ("decode", D.Opts(microbatch=2), "microbatch"),
                             ("decode", D.Opts(impl="xla"), "impl")):
        with pytest.raises(NotImplementedError, match=name):
            D.check_opts(opts, kind)
    D.check_opts(D.Opts(weight_dtype="int8", cache_dtype="int8"), "decode")
    D.check_opts(D.Opts(opt_state_dtype="bfloat16", microbatch=2), "train")


def test_input_specs_follow_the_reference():
    for arch, shape, want in (
            ("granite-3-2b", "train_4k", {"tokens": (256, 4096), "labels": (256, 4096)}),
            ("granite-3-2b", "decode_32k", {"tokens": (128, 1), "pos": (128,)}),
            ("whisper-tiny", "prefill_32k", {"tokens": (32, 32768), "frames": (32, 1500, 384)}),
            ("llava-next-34b", "prefill_32k", {"tokens": (32, 32768),
                                               "patches": (32, 2880, 7168)}),
            ("llava-next-34b", "decode_32k", {"tokens": (128, 1), "pos": (128,)})):
        cfg = get_config(arch)
        got = input_specs(cfg, SHAPES[shape], device="meta")
        assert {k: tuple(v.shape) for k, v in got.items()} == want
        for k, v in got.items():
            assert v.dtype == (torch.int32 if k in ("tokens", "labels", "pos")
                               else torch.bfloat16)


def test_the_production_meshes():
    import torch.distributed as dist
    single = make_production_mesh(device="cpu")
    assert (tuple(single.shape), single.mesh_dim_names) == ((16, 16), ("data", "model"))
    multi = make_production_mesh(multi_pod=True, device="cpu")
    assert (tuple(multi.shape), multi.mesh_dim_names) == ((2, 16, 16),
                                                           ("pod", "data", "model"))
    assert dist.get_world_size() == 512 and dist.get_backend() == "fake"
    assert D.mesh_chips(multi) == 512


# ----------------------------------------------------------------------
# the kernel wrappers' shape-only path
# ----------------------------------------------------------------------
def _refuse_build(monkeypatch):
    def load(name):
        raise AssertionError(f"built {name} for a fake operand")
    monkeypatch.setattr(build, "load", load)


def _fake_call(fn, *shapes_dtypes, **kw):
    """fn on fake tensors of the given (shape, dtype); (outputs, record)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(), build.recording_costs() as record:
        args = [torch.empty(s, dtype=d) if s is not None else None
                for s, d in shapes_dtypes]
        out = fn(*args, **kw)
    return out, record


def _meta(t):
    return (tuple(t.shape), t.dtype)


def _same_meta(fake, real):
    fake = fake if isinstance(fake, (tuple, list)) else (fake,)
    real = real if isinstance(real, (tuple, list)) else (real,)
    assert [_meta(t) for t in fake if t is not None] == \
        [_meta(t) for t in real if t is not None]


def _real(shape, dtype, rng):
    if dtype == torch.int32:
        return torch.from_numpy(rng.integers(1, 4, shape).astype(np.int32))
    if dtype == torch.int8:
        return torch.from_numpy(rng.integers(-3, 4, shape).astype(np.int8))
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _launch_counts():
    return [w.launches for w in (da.decode_attention, pa.paged_decode_attention,
                                 pa.paged_prefill_attention, fa.flash_attention,
                                 fa.flash_attention_bwd, gm.moe_gmm, gm.moe_gmm_bwd,
                                 rs.rglru_scan, rs.rglru_scan_bwd)]


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_decode_attention_shape_only(monkeypatch, kv):
    _refuse_build(monkeypatch)
    before = _launch_counts()
    B, S, H, KV, hd = 2, 96, 8, 2, 64
    kdt = getattr(torch, kv)
    sd = [((B, 1, H, hd), torch.bfloat16), ((B, S, KV, hd), kdt), ((B, S, KV, hd), kdt),
          ((B,), torch.int32)]
    out, rec = _fake_call(da.decode_attention, *sd, return_lse=True)
    rng = np.random.default_rng(0)
    real = [_real(s, d, rng) for s, d in sd]
    _same_meta(out, ref.decode_attention(*real, return_lse=True))
    isz = 2
    n_bytes = isz * 2 * B * H * hd + 2 * B * S * KV * hd * kdt.itemsize + 4 * B + 4 * B * H
    assert rec == {"decode_attention": {"calls": 1, "flops": 4.0 * B * H * S * hd,
                                        "bytes": float(n_bytes)}}
    assert _launch_counts() == before


def test_paged_attention_shape_only(monkeypatch):
    _refuse_build(monkeypatch)
    before = _launch_counts()
    B, C, H, KV, hd, pages, page, P = 2, 5, 8, 2, 64, 9, 16, 3
    pool = ((pages, page, KV, hd), torch.bfloat16)
    bt, kl = ((B, P), torch.int32), ((B,), torch.int32)
    rng = np.random.default_rng(1)
    out, rec = _fake_call(pa.paged_decode_attention, ((B, 1, H, hd), torch.bfloat16),
                          pool, pool, bt, kl)
    real = [_real(s, d, rng) for s, d in (((B, 1, H, hd), torch.bfloat16), pool, pool, bt)]
    _same_meta(out, ref.paged_decode_attention(*real, torch.full((B,), 20, dtype=torch.int32)))
    keys = B * P * page
    assert rec["paged_decode_attention"] == {
        "calls": 1, "flops": 4.0 * H * keys * hd,
        "bytes": float(2 * 2 * B * H * hd + 2 * keys * KV * hd * 2 + 4 * B * P + 4 * B)}
    out, rec = _fake_call(pa.paged_prefill_attention, ((B, C, H, hd), torch.bfloat16),
                          pool, pool, bt, kl, kl)
    real = [_real(s, d, rng) for s, d in (((B, C, H, hd), torch.bfloat16), pool, pool, bt)]
    _same_meta(out, ref.paged_prefill_attention(
        *real, torch.full((B,), 20, dtype=torch.int32), torch.full((B,), 15, dtype=torch.int32)))
    assert rec["paged_prefill_attention"] == {
        "calls": 1, "flops": 4.0 * C * H * keys * hd,
        "bytes": float(2 * 2 * B * C * H * hd + 2 * keys * KV * hd * 2 + 4 * B * P + 8 * B)}
    assert _launch_counts() == before


@pytest.mark.parametrize("mask", [dict(causal=True), dict(causal=True, window=24),
                                  dict(causal=False), dict(causal=True, chunk=32)],
                         ids=["causal", "window", "none", "chunk"])
def test_flash_attention_shape_only_forward_and_backward(monkeypatch, mask):
    """The forward and, under autograd, FlashAttentionFn's backward: fake
    outputs and gradients of the plain version's shapes, the visible pairs
    counted as ``ref.attention_mask`` counts them."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    _refuse_build(monkeypatch)
    before = _launch_counts()
    B, Sq, Skv, H, KV, hd = 2, 40, 72, 4, 2, 64
    pairs = int(ref.attention_mask(Sq, Skv, causal=mask["causal"], window=mask.get("window", 0),
                                   chunk=mask.get("chunk", 0), device="cpu").sum()) * H * B
    assert fa.visible_pairs(Sq, Skv, mask["causal"], mask.get("window", 0),
                            mask.get("chunk", 0)) * H * B == pairs
    with FakeTensorMode(), build.recording_costs() as rec:
        q = torch.empty(B, Sq, H, hd, dtype=torch.bfloat16, requires_grad=True)
        k = torch.empty(B, Skv, KV, hd, dtype=torch.bfloat16, requires_grad=True)
        v = torch.empty(B, Skv, KV, hd, dtype=torch.bfloat16, requires_grad=True)
        out = fa.flash_attention(q, k, v, **mask)
        grads = torch.autograd.grad(out.sum(), (q, k, v))
    assert _meta(out) == ((B, Sq, H, hd), torch.bfloat16)
    assert [_meta(g) for g in grads] == [_meta(t) for t in (q, k, v)]
    qb, kb = 2 * B * Sq * H * hd, 2 * B * Skv * KV * hd
    lse = 4 * B * H * Sq
    assert rec == {"flash_attention": {"calls": 1, "flops": 4.0 * hd * pairs,
                                       "bytes": float(2 * qb + 2 * kb + lse)},
                   "flash_attention_bwd": {"calls": 1, "flops": 10.0 * hd * pairs,
                                           "bytes": float(4 * qb + 4 * kb + lse)}}
    assert _launch_counts() == before


def test_moe_gmm_shape_only_forward_and_backward(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    _refuse_build(monkeypatch)
    before = _launch_counts()
    T, K, N, E = 24, 32, 48, 3
    with FakeTensorMode(), build.recording_costs() as rec:
        x = torch.empty(T, K, dtype=torch.bfloat16, requires_grad=True)
        w = torch.empty(E, K, N, dtype=torch.bfloat16, requires_grad=True)
        gs = torch.empty(E, dtype=torch.int32)
        out = gm.moe_gmm(x, w, gs)
        dx, dw = torch.autograd.grad(out.sum(), (x, w))
    rng = np.random.default_rng(2)
    real = ref.moe_gmm(_real((T, K), torch.bfloat16, rng), _real((E, K, N), torch.bfloat16, rng),
                       torch.tensor([10, 0, 14], dtype=torch.int32))
    assert _meta(out) == _meta(real)
    assert (_meta(dx), _meta(dw)) == (((T, K), torch.bfloat16), ((E, K, N), torch.bfloat16))
    used = min(E, T)
    assert rec == {
        "moe_gmm": {"calls": 1, "flops": 2.0 * T * K * N,
                    "bytes": float(2 * (T * K + T * N + used * K * N) + 4 * E)},
        "moe_gmm_bwd": {"calls": 1, "flops": 4.0 * T * K * N,
                        "bytes": float(2 * (T * N + used * K * N + T * K) + 4 * E
                                       + 2 * (T * K + T * N + E * K * N) + 4 * E)}}
    assert _launch_counts() == before


def test_rglru_scan_shape_only_forward_and_backward(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    _refuse_build(monkeypatch)
    before = _launch_counts()
    B, S, D_ = 2, 33, 40
    with FakeTensorMode(), build.recording_costs() as rec:
        a = torch.empty(B, S, D_, dtype=torch.float32, requires_grad=True)
        b = torch.empty(B, S, D_, dtype=torch.float32, requires_grad=True)
        h0 = torch.empty(B, D_, dtype=torch.float32, requires_grad=True)
        h = rs.rglru_scan(a, b, h0)
        grads = torch.autograd.grad(h.sum(), (a, b, h0))
    rng = np.random.default_rng(3)
    assert _meta(h) == _meta(ref.rglru_scan(*(_real(s, torch.float32, rng)
                                              for s in ((B, S, D_), (B, S, D_), (B, D_)))))
    assert [_meta(g) for g in grads] == [_meta(t) for t in (a, b, h0)]
    n, s0 = B * S * D_, B * D_
    assert rec == {"rglru_scan": {"calls": 1, "flops": 2.0 * n,
                                  "bytes": float(4 * (3 * n + s0))},
                   "rglru_scan_bwd": {"calls": 1, "flops": 3.0 * n,
                                      "bytes": float(4 * (5 * n + 2 * s0))}}
    assert _launch_counts() == before


def test_wrapper_checks_run_on_fake_operands(monkeypatch):
    """What lowering would refuse, the shape-only path refuses too."""
    _refuse_build(monkeypatch)
    with pytest.raises(ValueError, match="head_dim"):
        _fake_call(da.decode_attention, ((2, 1, 8, 48), torch.bfloat16),
                   ((2, 16, 2, 48), torch.bfloat16), ((2, 16, 2, 48), torch.bfloat16),
                   ((2,), torch.int32))
    with pytest.raises(ValueError, match="multiple of 8"):
        _fake_call(gm.moe_gmm, ((4, 12), torch.bfloat16), ((2, 12, 16), torch.bfloat16),
                   ((2,), torch.int32))
    with pytest.raises(TypeError, match="one dtype"):
        _fake_call(fa.flash_attention, ((1, 8, 2, 64), torch.bfloat16),
                   ((1, 8, 2, 64), torch.float32), ((1, 8, 2, 64), torch.bfloat16))


def test_split_plans_on_a_fake_operand_assume_the_h100_sxm():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        assert build.n_sms(torch.empty(2)) == build.H100_SXM_SMS == 132
    assert not build.is_fake(torch.empty(2))


# ----------------------------------------------------------------------
# the collective counter
# ----------------------------------------------------------------------
def test_collectives_counted_by_hand_on_a_fake_mesh():
    """On a fake (2, 4) mesh: a bf16 (8, 16) tensor sharded on dim 0 over
    data and gathered (all-gather, result 8 x 16 x 2 bytes) and a float32
    one reduced from Partial to Replicate (all-reduce, 64 x 4) and to
    Shard(0) (reduce-scatter, result 2 x 8 x 4) over model, through
    DTensor's functional collectives; c10d's all-to-all of 16 float32 over
    model and all-reduce of 10 float32 on the whole group; the async
    pairs' waits not counted."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    _fresh_fake_group(8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    with D.fake_mode():
        a = DTensor.from_local(torch.empty(4, 16, dtype=torch.bfloat16), mesh,
                               [Shard(0), Replicate()], run_check=False)
        p = DTensor.from_local(torch.empty(8, 8), mesh, [Replicate(), Partial()],
                               run_check=False)
        flat = torch.empty(10)
        counter = C.StepCounter()
        with counter:
            a.redistribute(mesh, [Replicate(), Replicate()]).to_local()
            p.redistribute(mesh, [Replicate(), Replicate()]).to_local()
            p.redistribute(mesh, [Replicate(), Shard(0)]).to_local()
            dist.all_to_all_single(torch.empty(16), torch.empty(16),
                                   group=mesh.get_group("model"))
            dist.all_reduce(flat)
    total, per_type, counts = counter.collective_bytes()
    assert counts == {"all-gather": 1, "all-reduce": 2, "reduce-scatter": 1,
                      "all-to-all": 1, "collective-permute": 0}
    assert per_type == {"all-gather": 8 * 16 * 2, "all-reduce": 64 * 4 + 10 * 4,
                        "reduce-scatter": 2 * 8 * 4, "all-to-all": 16 * 4,
                        "collective-permute": 0}
    assert total == sum(per_type.values())
    assert counter.by_op["c10d.allreduce_"] == counter.by_op["c10d.alltoall_base_"] == 1


def test_step_counter_memory_and_flops():
    """A product's FLOPs from its local shapes; what a step allocates
    beyond its tracked arguments, freed storages leaving the live sum."""
    with D.fake_mode():
        x, w = torch.empty(64, 32), torch.empty(32, 16)
        counter = C.StepCounter()
        counter.track([x, w])
        with counter:
            y = x @ w                       # 64 x 16 float32: 4096 bytes
            z = torch.relu(y)               # 4096 more, peak 8192
            del y
            x.add_(1.0)                     # in place: nothing allocated
            u = z * 2                       # y freed: live 8192 again
    assert counter.flops == 2 * 64 * 32 * 16
    assert counter.peak == 8192 and counter.live == 8192
    del z, u


# ----------------------------------------------------------------------
# the entry point, the sweep, the profiles
# ----------------------------------------------------------------------
def test_cli_single_combo_subprocess():
    """The port's dry-run entry point at full width: granite-3-2b's 40
    layers, decode_32k, 256 fake ranks (the twin of the reference's
    ``test_dryrun_single_combo_subprocess``)."""
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "granite-3-2b", "--shape", "decode_32k", "--mesh", "single"],
        env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "1 ok, 0 skipped, 0 errors" in out.stdout


def test_step_time_and_roofline_profile_read_the_sweep(tmp_path, monkeypatch):
    """Rows ``run_combo`` wrote (granite-3-2b and whisper-tiny at full
    width; whisper-tiny x long_500k a skip): ``step_time`` gives each ok
    row's roofline step time, ``roofline_profile`` the reference's sweep
    branch where an arch has both rows and the analytic branch where not."""
    rows = [D.run_combo(a, s, "single", verbose=False, device="cpu")
            for a, s in (("granite-3-2b", "prefill_32k"), ("granite-3-2b", "decode_32k"),
                         ("whisper-tiny", "decode_32k"), ("whisper-tiny", "long_500k"))]
    assert [r["status"] for r in rows] == ["ok", "ok", "ok", "skip"]
    sweep = tmp_path / "sweep.json"
    sweep.write_text(json.dumps(rows))
    granite, whisper = get_config("granite-3-2b"), get_config("whisper-tiny")
    analytic = SM.roofline_profile(granite, batch=2, new_tokens=16, prompt_len=64)
    monkeypatch.setattr(SM, "SWEEP", sweep)
    t_pre, t_dec = (SM.step_time("granite-3-2b", s) for s in ("prefill_32k", "decode_32k"))
    assert (t_pre, t_dec) == (rows[0]["report"]["step_time"], rows[1]["report"]["step_time"])
    assert SM.step_time("whisper-tiny", "long_500k") is None
    assert SM.step_time("granite-3-2b", "decode_32k", "multi") is None
    got = SM.roofline_profile(granite, batch=2, new_tokens=16, prompt_len=64)
    want = t_pre * (2 / 32) * (64 / 32768) + 16 * t_dec * (2 / 128)
    assert got.elat_median_s == pytest.approx(max(want, 1e-4), rel=1e-12)
    assert got.elat_median_s != analytic.elat_median_s
    assert got.cold_start_s == analytic.cold_start_s
    # whisper-tiny has no prefill row: the analytic branch
    assert SM.roofline_profile(whisper, batch=2, new_tokens=16, prompt_len=64) == \
        _analytic_profile(whisper)


def _analytic_profile(cfg):
    peak = SM.PEAK_FLOPS * SM.SIM_NODE.chips * SM.MFU
    t_pre = 2 * cfg.n_active_params * 2 * 64 / peak
    t_dec = max(2 * cfg.n_active_params * 2 / peak, 2e-4)
    from repro_torch.core.runtime import SimProfile
    return SimProfile(elat_median_s=max(t_pre + 16 * t_dec, 1e-4), sigma=0.08,
                      cold_start_s=20.0 + cfg.n_params * 2 / 1.25e9 / 16,
                      result_bytes=2 * 16 * 4)
