"""The tiny sizes of the drivers that came after ``tests/helpers.py``'s
``TINY``, for the tests of ``bench_port/tests`` that run every cell of the
manifest at a tiny size: ``eval_streaming_ref`` runs the tiny flagship with
the DINOv3 ViT-7B/16 entry at a width of 256 (2 heads of 128, SwiGLU 512,
no q/k/v bias, 4 storage tokens, two blocks, 64-px crops), held and run in
bf16 as the cell's configuration runs it."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port.tests import helpers  # noqa: E402

TINY_VIT7B = {"sampler.sampling_steps": 5, "model.backbone": "dinov3_vit7b16",
              "model.dino_dim": 256, "model.backbone_dtype": "bfloat16"}
helpers.TINY.setdefault("eval_streaming_ref", ("tiny_flagship_config", TINY_VIT7B,
                                               {"objects": 3, "pool": 2}))
