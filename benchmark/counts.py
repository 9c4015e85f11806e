"""Operations and bytes of a configuration's work, counted from its shapes,
whatever kernels the program runs for them.

A product ``[M, K] x [K, N]`` takes ``2 M K N`` operations and, at least,
reads each operand once and writes its result once. An attention core over
``B`` sequences of ``S`` tokens, ``H`` heads of width ``D`` (``W = H D``)
takes ``4 B S^2 W`` operations (the logits and the weighted sum; a causal
core the ``S (S + 1) / 2`` pairs it keeps) and moves q, k, v and the context.
Its backward takes twice the operations (dV, dP, dQ, dK) and moves q, k, v,
the context, its gradient and dq, dk, dv. A product's backward is two
products of its size. Element-wise work, LayerNorms, softmax statistics and
the preprocessing are not counted, so the sums are lower bounds.
"""

from __future__ import annotations

from typing import List, Mapping, Tuple

# (operations, bytes at the compute dtype's width)
Work = Tuple[float, float]
# bytes an element of each compute dtype takes
WIDTH = {"float32": 4, "bfloat16": 2}


def _mm(m: int, k: int, n: int, width: int) -> Work:
    return 2.0 * m * k * n, float(width * (m * k + k * n + m * n))


def _core(b: int, s: int, w: int, causal: bool, width: int) -> Work:
    pairs = s * (s + 1) / 2 if causal else s * s
    return 4.0 * b * pairs * w, float(width * 4 * b * s * w)


def _tower(b: int, s: int, w: int, layers: int, causal: bool, width: int) -> List[Work]:
    m = b * s
    per_layer = [_mm(m, w, 3 * w, width), _core(b, s, w, causal, width),
                 _mm(m, w, w, width), _mm(m, w, 4 * w, width), _mm(m, 4 * w, w, width)]
    return per_layer * layers


def vision_forward(cfg: Mapping, b: int, width: int) -> List[Work]:
    """The image tower on ``b`` images: patch embedding, blocks, projection."""
    v = cfg["vision"]
    p, w = v["patch_size"], v["width"]
    tokens = (v["image_size"] // p) ** 2
    return ([_mm(b * tokens, p * p * 3, w, width)]
            + _tower(b, tokens + 1, w, v["layers"], False, width)
            + [_mm(b, w, cfg["embed_dim"], width)])


def text_forward(cfg: Mapping, b: int, width: int) -> List[Work]:
    """The text tower on ``b`` captions (the token lookup moves no operands
    of a product): blocks over the whole context, projection."""
    t = cfg["text"]
    return (_tower(b, t["context_length"], t["width"], t["layers"], True, width)
            + [_mm(b, t["width"], cfg["embed_dim"], width)])


def _backward(work: Work) -> List[Work]:
    """A forward product's or core's backward: twice its operations; a
    product's two gradients move as much as it did each, a core's eight
    tensors twice its four."""
    ops, nbytes = work
    return [(2 * ops, 2 * nbytes)]


def train_step(cfg: Mapping, b: int, width: int) -> List[Work]:
    """Forward and backward of both towers and the logits on a batch of
    ``b`` pairs; no recomputation is counted."""
    fwd = vision_forward(cfg, b, width) + text_forward(cfg, b, width)
    fwd.append(_mm(b, cfg["embed_dim"], b, width))
    return fwd + [w for f in fwd for w in _backward(f)]


def total_ops(works: List[Work]) -> float:
    return sum(o for o, _ in works)


def least_seconds(works: List[Work], flops: float, bytes_per_s: float) -> float:
    """Sum over products and cores of the longer of their operations at the
    peak rate and their bytes at the memory's rate."""
    return sum(max(o / flops, b / bytes_per_s) for o, b in works)
