"""Weights of a configuration, drawn on the device from the run's seed.

One ``torch.randn`` call fills every random leaf; each leaf is a scaled
slice of it, with OpenAI CLIP's initialization (``model.py``
``initialize_parameters``): N(0, W^-1/2) for the patch embedding, class and
position embeddings and projections, N(0, 0.02) token and N(0, 0.01) text
position embeddings, the blocks' qkv at W^-1/2, out and fc2 at
W^-1/2 (2L)^-1/2, fc1 at (2W)^-1/2; LayerNorms at 1 and 0, biases 0, the
logit scale ln(1/0.07). The same seed on the same device gives the same
tensors, so the program and the reference are handed the same numbers, each
drawing its own copy.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import torch

# a leaf: (name, shape, init) with init a float std, "ones", "zeros" or
# ("const", value)
Leaf = Tuple[str, Tuple[int, ...], object]


def _ln(pre: str, w: int) -> List[Leaf]:
    return [(pre + ".scale", (w,), "ones"), (pre + ".bias", (w,), "zeros")]


def _blocks(pre: str, w: int, layers: int) -> List[Leaf]:
    out_std = w ** -0.5 * (2 * layers) ** -0.5
    leaves: List[Leaf] = []
    for i in range(layers):
        b = f"{pre}.{i}"
        leaves += _ln(b + ".ln1", w)
        leaves += [(b + ".attn.qkv.kernel", (w, 3 * w), w ** -0.5),
                   (b + ".attn.qkv.bias", (3 * w,), "zeros"),
                   (b + ".attn.out.kernel", (w, w), out_std),
                   (b + ".attn.out.bias", (w,), "zeros")]
        leaves += _ln(b + ".ln2", w)
        leaves += [(b + ".mlp.fc1.kernel", (w, 4 * w), (2 * w) ** -0.5),
                   (b + ".mlp.fc1.bias", (4 * w,), "zeros"),
                   (b + ".mlp.fc2.kernel", (4 * w, w), out_std),
                   (b + ".mlp.fc2.bias", (w,), "zeros")]
    return leaves


def leaves(cfg: Mapping) -> List[Leaf]:
    """Every parameter of the configuration ``cfg`` (a file of
    ``benchmark/configs``), in a fixed order."""
    v, t, e = cfg["vision"], cfg["text"], cfg["embed_dim"]
    wv, wt, p = v["width"], t["width"], v["patch_size"]
    seq = (v["image_size"] // p) ** 2 + 1
    out = [("visual.patch_embed.kernel", (p * p * 3, wv), wv ** -0.5),
           ("visual.class_embedding", (wv,), wv ** -0.5),
           ("visual.pos_embed", (seq, wv), wv ** -0.5)]
    out += _ln("visual.ln_pre", wv) + _blocks("visual.blocks", wv, v["layers"])
    out += _ln("visual.ln_post", wv) + [("visual.proj.kernel", (wv, e), wv ** -0.5)]
    out += [("text.token_embed", (t["vocab_size"], wt), 0.02),
            ("text.pos_embed", (t["context_length"], wt), 0.01)]
    out += _blocks("text.blocks", wt, t["layers"]) + _ln("text.ln_final", wt)
    out += [("text.proj.kernel", (wt, e), wt ** -0.5),
            ("logit_scale", (), ("const", math.log(1 / 0.07)))]
    return out


def make_weights(cfg: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device``, from ``seed``."""
    spec = leaves(cfg)
    n = sum(math.prod(s) for _, s, init in spec if isinstance(init, float))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    flat = torch.randn(n, generator=gen, device=device)
    out, off = {}, 0
    for name, shape, init in spec:
        k = math.prod(shape)
        if isinstance(init, float):
            out[name] = flat[off:off + k].view(shape).mul_(init)
            off += k
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.full(shape, init[1], device=device)
    return out
