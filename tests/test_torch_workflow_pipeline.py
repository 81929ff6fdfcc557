"""The port's twin of ``examples/workflow_pipeline.py`` (tiny-YOLO fan-out
+ whisper fan-in -> LLM captioner) against the reference example, on the
CPU at the example's own sizes (``--reduced``) with the weights of the
reference runtimes' ``setup()`` handed to the twin's through the bridge:
the vision detections, the audio transcript and the caption tokens equal
what the reference's ``fn``s give on the same payloads, step by step and
through a whole workflow on the twin's ``SimBackend``; ``main`` completes
the pipeline on both backends."""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.examples import workflow_pipeline as twin

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "reference_workflow_pipeline", REPO / "examples" / "workflow_pipeline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(params):
    return bridge.from_jax(jax.tree_util.tree_map(np.asarray, jax.device_get(params)),
                           device="cpu")


@pytest.fixture(scope="module")
def pair():
    """(reference runtimes, twin runtimes on the reference's weights,
    reference handles) keyed by step."""
    ref = _reference_example()
    jdefs = {"see": ref.vision_runtime(), "hear": ref.audio_runtime(),
             "caption": ref.caption_runtime()}
    handles = {k: d.setup() for k, d in jdefs.items()}
    tdefs = {
        "see": twin.vision_runtime("cpu", params=_tree(handles["see"])),
        "hear": twin.audio_runtime("cpu", reduced=True,
                                   params=_tree(handles["hear"])),
        "caption": twin.caption_runtime("cpu", reduced=True,
                                        params=_tree(handles["caption"].params)),
    }
    return jdefs, tdefs, handles


def _images():
    return twin.make_images(2, twin.image_side(reduced=True))


def _reference_chain(jdefs, handles, images):
    seen = [jdefs["see"].fn(img, {"handle": handles["see"]}) for img in images]
    heard = jdefs["hear"].fn({"audio_seed": 7}, {"handle": handles["hear"]})
    cap = jdefs["caption"].fn(seen + [heard], {"handle": handles["caption"]})
    return seen, heard, cap


def test_runtime_ids_and_profiles_match(pair):
    jdefs, tdefs, _ = pair
    for key, jdef in jdefs.items():
        tdef = tdefs[key]
        assert tdef.runtime_id == jdef.runtime_id
        assert tdef.artifact_bytes == jdef.artifact_bytes
        # the reference's host type is host-jax, the port's host-cuda
        want = {k.replace("host-jax", "host-cuda"): dataclasses.asdict(v)
                for k, v in jdef.profiles.items()}
        assert {k: dataclasses.asdict(v) for k, v in tdef.profiles.items()} == want


def test_each_step_equals_the_reference(pair):
    jdefs, tdefs, handles = pair
    images = _images()
    seen, heard, cap = _reference_chain(jdefs, handles, images)
    assert [tdefs["see"].fn(img, {}) for img in images] == seen
    assert tdefs["hear"].fn({"audio_seed": 7}, {}) == heard
    assert tdefs["caption"].fn(seen + [heard], {}) == cap
    assert len(cap["caption"]) == twin.CAPTION_NEW


def test_whole_workflow_on_the_twin_equals_the_reference_chain(pair):
    from repro_torch.core.cluster import GPU_K600, VPU_NCS, Cluster
    from repro_torch.gateway import Gateway, SimBackend
    jdefs, tdefs, handles = pair
    images = _images()
    _, _, cap = _reference_chain(jdefs, handles, images)
    cluster = Cluster(scheduler="warm", seed=0)
    cluster.add_node("vpu-pod", [VPU_NCS])
    cluster.add_node("gpu-pod", [GPU_K600, GPU_K600])
    gw = Gateway(SimBackend(cluster))
    for tdef in tdefs.values():
        gw.register(tdef)
    fut = gw.submit_workflow(twin.make_workflow(images))
    assert fut.result() == cap
    assert set(fut.statuses().values()) == {"done"}
    assert fut.step_future("see[0]").invocation.accelerator.endswith("(vpu-ncs)")
    assert fut.step_future("caption").invocation.accelerator.endswith("(gpu-k600)")


@pytest.mark.parametrize("backend", ["sim", "engine"])
def test_main_completes_the_pipeline(backend, capsys):
    assert twin.main(["--backend", backend, "--reduced", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "pipeline COMPLETED" in out
    assert out.count("  step ") == 4 and f"[{backend}] workflow 'caption-pipeline'" in out
