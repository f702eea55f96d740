"""Assigned input-shape profiles (port of the JAX package's
`configs/shapes.py`; the same four for every LM-family arch).

train_4k / prefill_32k build the train step / `Model.prefill`; decode_32k
and long_500k build the serve step (one new token against a seq_len-deep
cache). long_500k needs sub-quadratic state and only runs for the SSM /
hybrid / local-attention architectures (see configs.ARCHS[...]'s second
field).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeProfile:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeProfile("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeProfile("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeProfile("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeProfile("long_500k", "decode", 524_288, 1),
}
