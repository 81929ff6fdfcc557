"""tiny-YOLOv2, the paper's own evaluation workload [18, YOLO9000].

Hardless §V runs tinyyolov2.7 (ONNX) image detection on 2x K600 GPUs and
one Movidius NCS. Registered under its own id with family DENSE and a
2-layer stub transformer config, as ``repro.configs.tinyyolo_v2`` is (the
reference's conv net lives in ``repro.models.yolo`` and is not ported
yet).
"""
from repro_torch.configs.base import Family, ModelConfig, register


@register("tinyyolo-v2")
def config() -> ModelConfig:
    return ModelConfig(
        name="tinyyolo-v2",
        family=Family.DENSE,
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab=125,  # 5 boxes x 25 predictions per cell (VOC-20)
        source="arXiv:1612.08242 (YOLO9000), onnx tinyyolov2.7",
    )
