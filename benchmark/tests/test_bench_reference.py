"""The reference against the program on the CPU at a small size, from the same
weights: preprocessing and embeddings, the InfoNCE loss, the augmentation,
and the parameters after one AdamW step."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import traffic
from benchmark.program import build_model
from benchmark.reference import clip as ref
from benchmark.reference.preprocess import preprocess, sample_warp, warp_normalize
from benchmark.weights import make_weights

HERE = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny():
    cfg = json.loads((HERE / "configs" / "plip-vit-b32.json").read_text())
    cfg["vision"] = {"image_size": 32, "patch_size": 16, "width": 64, "layers": 2, "heads": 4}
    cfg["text"] = dict(cfg["text"], width=32, layers=2, heads=4)
    cfg["embed_dim"] = 24
    return cfg


def test_weights_load_into_program_and_repeat():
    cfg = tiny()
    w1, w2 = make_weights(cfg, 2 ** 31 + 3, "cpu"), make_weights(cfg, 2 ** 31 + 3, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    model = build_model(cfg, w1, "cpu")  # strict load: every name and shape matches
    assert set(dict(model.named_parameters())) == set(w1)
    assert not torch.equal(w1["visual.proj.kernel"],
                           make_weights(cfg, 4, "cpu")["visual.proj.kernel"])


def test_preprocess_and_embeddings_match_program():
    from plip_tpu_torch.ops.preprocess import preprocess_images

    cfg = tiny()
    W = make_weights(cfg, 11, "cpu")
    model = build_model(cfg, W, "cpu")
    tiles = traffic.tile_pool(6, 48, 11, "cpu")
    mine = preprocess(torch.from_numpy(tiles), 32)
    theirs = preprocess_images(list(tiles), 32, device="cpu")
    assert torch.equal(mine, theirs)
    with torch.no_grad():
        want = ref.encode_image(W, mine, cfg)
        got = model.encode_image(theirs, torch.float32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_augmentation_matches_program():
    from plip_tpu_torch.ops.augment import AugmentConfig, augment_batch

    # bit for bit at the cells' sizes: an ulp of the map moves a bilinear
    # sample to the next pixel
    mix = json.loads((HERE / "mixes" / "train.fp32.b128.json").read_text())
    aug = {"out_size": 224, **mix["augment"]}
    cfg = AugmentConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in aug.items()})
    tiles = torch.from_numpy(traffic.tile_pool(16, 256, 2, "cpu"))
    g1, g2 = torch.Generator().manual_seed(3100000001), torch.Generator().manual_seed(3100000001)
    for _ in range(2):
        got = augment_batch(g1, tiles, cfg)
        want = warp_normalize(tiles, *sample_warp(g2, 16, 256, aug), aug)
        assert torch.equal(got, want)


def test_loss_and_one_adamw_step_match_program():
    from plip_tpu_torch.train.contrastive import (init_train_state, make_optimizer,
                                                  make_train_step)

    cfg = tiny()
    W = make_weights(cfg, 5, "cpu")
    model = build_model(cfg, W, "cpu")
    opt = make_optimizer(base_lr=5e-5, warmup=50, total_steps=1000, weight_decay=0.2)
    state = init_train_state(model, opt)
    step = make_train_step(model.cfg, opt, dtype=torch.float32, remat=False)
    g = torch.Generator().manual_seed(5)
    pixels = torch.randn((6, 32, 32, 3), generator=g)
    ids = torch.zeros((6, 77), dtype=torch.long)
    ids[:, 0] = 49406
    ids[:, 1:6] = torch.randint(0, 49000, (6, 5), generator=g)
    ids[:, 6] = 49407
    state, metrics = step(state, pixels, ids)

    P = {k: v.clone().requires_grad_(True) for k, v in W.items()}
    loss = ref.infonce(P, pixels, ids, cfg)
    grads = dict(zip(P, torch.autograd.grad(loss, list(P.values()))))
    adam = ref.AdamW(ref.cosine_lr(5e-5, 50, 1000), 0.2)
    adam.step(P, grads)
    assert float(metrics["loss"]) == pytest.approx(float(loss.detach()), rel=1e-6)
    for k, p in model.named_parameters():
        # Adam's first step is g / |g|: an element whose gradient is round-off
        # (a key's bias under softmax) moves by its sign, whichever it is
        real = grads[k].abs() >= 1e-3 * grads[k].abs().max()
        torch.testing.assert_close(p.detach()[real], P[k].detach()[real], rtol=1e-6,
                                   atol=1e-9)
        # the first moment holds (1 - b1) g, to round-off against the leaf's largest
        g = 0.1 * grads[k]
        torch.testing.assert_close(state.opt_state.mu[k], g, rtol=1e-4,
                                   atol=1e-5 * float(g.abs().max()) + 1e-30)


def test_cosine_schedule():
    s = ref.cosine_lr(5e-5, 50, 1000)
    assert s(0) == pytest.approx(1e-6)
    assert s(49) == pytest.approx(5e-5)
    assert s(1000) == pytest.approx(0.0, abs=1e-12)
    assert np.isclose(s(525), 2.5e-5)
