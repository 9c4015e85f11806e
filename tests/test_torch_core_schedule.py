"""The Hopper attention cores' two-pass schedule, emulated in plain PyTorch
on the CPU, against the port's plain versions.

``csrc/mha.cu`` and ``csrc/mha_bwd.cu`` walk the keys in 64-key tiles in two
passes. The first carries the fp32 row max and, with it, the fp32 row sum
(and the backward's sum of dp * e) online: rescaled by exp(m_old - m_new)
whenever the max grows. The second forms e = exp(l - m) from the exact final
max and only then casts P (or dS) to bf16, where the TPU kernels cast it.
That reorders fp32 sums and nothing else, so it must meet the bf16 core bars
of PERF.md section 2 against ``headgrid_core_reference``,
``flash_core_reference``, ``attn_core_reference`` (deferred, and
normalize-first as K7 recomputes it), ``mha_core_bwd_reference`` and
``attn_core_bwd_reference``: at most ``DIFFER`` of the elements not
bit-equal, every element within ``ULPS`` bf16 ulps of its row's largest
value (2 for a backward's dqkv and for a normalize-first core over more than
512 keys). The flash-style online softmax, which casts P against the running
max and rescales the P . v accumulator, is the control: it must fail the
same bar. This pins on the CPU why the kernels' design is allowed and that
one is not.

Inputs are made with numpy from a seed. The emulation repeats the kernels'
order of work (tiles, passes, casts), not their fp32 summation order inside a
tile, which is the tensor cores' own.
"""

import functools

import numpy as np
import pytest
import torch

from plip_tpu_torch.ops import attention as T
from plip_tpu_torch.ops import attention_bwd as TB
from plip_tpu_torch.ops import mha as M


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread: under the suite's parallel workers the
    default threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TILE = 64  # keys a tile, as the kernels
HEADS, D = 2, 64
DIFFER = 0.005  # the bf16 bars (PERF.md section 2)
CORE_ULPS, LONG_ULPS, BWD_ULPS = 1, 2, 2
# (B, S, causal): the text tower's causal 77, ViT-L/14 vision, @336 vision,
# the longest sequence K1/K2's cores take
SHAPES = [(3, 77, True), (2, 257, False), (1, 577, False), (1, 1056, False)]
BF16 = torch.bfloat16


def _qkv(B, S, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((B, S, 3 * HEADS * D), dtype=np.float32)).to(BF16)


def _g(B, S, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((B, S, HEADS * D), dtype=np.float32)).to(BF16)


def _ulp_stats(got, want):
    """(share of the elements that differ, the worst |got - want| in bf16 ulps
    of the largest |want| of its row); rows are tokens."""
    got = got.reshape(-1, got.shape[-1]).float()
    want = want.reshape(-1, want.shape[-1]).float()
    d = (got - want).abs()
    _, e = torch.frexp(want.abs().amax(-1, keepdim=True))
    return (d != 0).float().mean().item(), (d / torch.ldexp(torch.ones_like(d), e - 8)).max().item()


def _meets(got, want, ulps):
    differ, worst = _ulp_stats(got, want)
    return differ <= DIFFER and worst <= ulps, (differ, worst)


def _heads(qkv, S):
    """fp32 q, k, v ``[B, H, S, D]`` of the bf16 values."""
    return qkv.reshape(-1, S, 3, HEADS, D).permute(2, 0, 3, 1, 4).float().unbind(0)


def _merge(t):
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], HEADS * D)


def _logits(qkv, S, causal, s_valid, scale_after):
    """The fp32 masked logits as the kernel computes them: K3, K5 and K12
    round q * D^-1/2 to bf16 before the dot, K1, K2 and K4 scale after it."""
    q, k, _ = _heads(qkv, S)
    if scale_after:
        logits = q @ k.transpose(-1, -2) * D ** -0.5
    else:
        logits = (q * D ** -0.5).to(BF16).float() @ k.transpose(-1, -2)
    return logits.masked_fill(~T.keep_mask(S, causal, s_valid, "cpu"), float("-inf"))


def _tiles(S):
    return [slice(j0, min(j0 + TILE, S)) for j0 in range(0, S, TILE)]


def _online(logits, dp=None):
    """Pass 1 (A): the row max m and, carried online, rs = sum exp(l - m)
    and (with dp) sigma = sum dp * exp(l - m), rescaled whenever m grows."""
    shape = logits.shape[:-1]
    m = torch.full(shape, float("-inf"))
    rs, sg = torch.zeros(shape), torch.zeros(shape)
    for t in _tiles(logits.shape[-1]):
        m_new = torch.maximum(m, logits[..., t].amax(-1))
        ref = torch.where(torch.isinf(m_new), torch.zeros_like(m_new), m_new)
        a = torch.exp(m - ref)
        e = torch.exp(logits[..., t] - ref[..., None])
        rs = rs * a + e.sum(-1)
        if dp is not None:
            sg = sg * a + (dp[..., t] * e).sum(-1)
        m = m_new
    return m, rs, sg


def two_pass_forward(logits, v, defer):
    """The kernels' forward: pass 1 the max (and the online sum when
    normalizing first); pass 2 P = cast(e / rs) or cast(e) from the exact max,
    P . v summed tile by tile in fp32, deferred divided at the end."""
    m, rs, _ = _online(logits)
    if defer:
        rs = torch.zeros_like(rs)
    acc = torch.zeros(*logits.shape[:-1], v.shape[-1])
    for t in _tiles(logits.shape[-1]):
        e = torch.exp(logits[..., t] - m[..., None])
        if defer:
            rs = rs + e.sum(-1)
            p = e.to(BF16)
        else:
            p = (e / rs[..., None]).to(BF16)
        acc = acc + p.float() @ v[..., t, :]
    return (acc / rs[..., None] if defer else acc).to(BF16)


def flash_forward(logits, v):
    """The control: the online softmax, P cast against the running max and
    the accumulator rescaled when the max grows."""
    shape = logits.shape[:-1]
    m = torch.full(shape, float("-inf"))
    rs, acc = torch.zeros(shape), torch.zeros(*shape, v.shape[-1])
    for t in _tiles(logits.shape[-1]):
        m_new = torch.maximum(m, logits[..., t].amax(-1))
        ref = torch.where(torch.isinf(m_new), torch.zeros_like(m_new), m_new)
        a = torch.exp(m - ref)
        e = torch.exp(logits[..., t] - ref[..., None])
        rs = rs * a + e.sum(-1)
        acc = acc * a[..., None] + e.to(BF16).float() @ v[..., t, :]
        m = m_new
    return (acc / rs[..., None]).to(BF16)


def two_pass_backward(qkv, g, S, causal, s_valid, deferred):
    """The kernels' backward: core_bwd_rows' pass A (online rs and sigma),
    dsum = sigma / rs (normalize-first) or dsum_u = sigma; pass B's dS cast
    from the exact max, dq summed tile by tile; core_bwd_keys' P and dS from
    the row statistics by the same formulas. Returns (ctx or None, dqkv)."""
    q, k, v = _heads(qkv, S)
    gh = g.reshape(-1, S, HEADS, D).transpose(1, 2).float()
    scale = D ** -0.5
    logits = _logits(qkv, S, causal, s_valid, scale_after=True)
    dp = gh @ v.transpose(-1, -2)
    m, rs, sg = _online(logits, dp)
    sub = sg / rs  # normalize-first: dsum; deferred: dsum_u / rs
    e = torch.exp(logits - m[..., None])
    w = e if deferred else e / rs[..., None]
    ds = (w * (dp - sub[..., None])).to(BF16).float()
    dq = torch.zeros_like(q)
    for t in _tiles(S):
        dq = dq + ds[..., t] @ k[..., t, :]
    dq = dq * scale
    r = rs[..., None]
    if deferred:
        e_c = e.to(BF16).float()
        ctx = torch.zeros_like(q)
        for t in _tiles(S):
            ctx = ctx + e_c[..., t] @ v[..., t, :]
        ctx = (ctx / r).to(BF16)
        dq = dq / r
        dv = e_c.transpose(-1, -2) @ (gh / r).to(BF16).float()
        dk = ds.transpose(-1, -2) @ (q / r).to(BF16).float() * scale
    else:
        ctx = None
        dv = w.to(BF16).float().transpose(-1, -2) @ gh
        dk = ds.transpose(-1, -2) @ q * scale
    dqkv = torch.stack([t.to(BF16) for t in (dq, dk, dv)], 2)  # [B, H, 3, S, D]
    dqkv = dqkv.permute(0, 3, 2, 1, 4).reshape(qkv.shape)
    return (None if ctx is None else _merge(ctx)), dqkv


# (name, plain version (qkv, S, causal, s_valid) -> ctx, scale after the dot,
# deferred divide, takes s_valid)
FORWARD = {
    "headgrid_core": (lambda x, S, c, sv: M.headgrid_core_reference(x, S, HEADS, c),
                      False, False, False),
    "flash_core": (lambda x, S, c, sv: M.flash_core_reference(x, S, HEADS, c),
                   False, True, False),
    "attn_core": (lambda x, S, c, sv: T.attn_core_reference(
        x.reshape(-1, 3 * HEADS * D), S, HEADS, c, sv, True).reshape(-1, S, HEADS * D),
        True, True, True),
    "attn_core normalize-first": (lambda x, S, c, sv: T.attn_core_reference(
        x.reshape(-1, 3 * HEADS * D), S, HEADS, c, sv, False).reshape(-1, S, HEADS * D),
        True, False, True),
}


def _forward_cases():
    for name, (_, _, _, takes_s_valid) in FORWARD.items():
        for B, S, causal in SHAPES:
            for s_valid in ((None, S - 7) if takes_s_valid else (None,)):
                yield pytest.param(name, B, S, causal, s_valid,
                                   id=f"{name}-S{S}{'c' if causal else ''}-sv{s_valid}")


def _emulated_forward(name, qkv, S, causal, s_valid):
    _, scale_after, defer, _ = FORWARD[name]
    logits = _logits(qkv, S, causal, s_valid, scale_after)
    return _merge(two_pass_forward(logits, _heads(qkv, S)[2], defer))


@functools.lru_cache(maxsize=None)
def _forward_pair(name, B, S, causal, s_valid):
    """(emulated, plain) forward of ``_qkv(B, S)``, once a module: the
    forward cases and the controls share it."""
    qkv = _qkv(B, S)
    return (_emulated_forward(name, qkv, S, causal, s_valid),
            FORWARD[name][0](qkv, S, causal, s_valid))


@pytest.mark.parametrize("name,B,S,causal,s_valid", list(_forward_cases()))
def test_two_pass_forward_meets_the_core_bar(name, B, S, causal, s_valid):
    _, _, defer, _ = FORWARD[name]
    got, want = _forward_pair(name, B, S, causal, s_valid)
    ulps = LONG_ULPS if not defer and S > 512 else CORE_ULPS
    ok, stats = _meets(got, want, ulps)
    assert ok, stats


@pytest.mark.parametrize("name", ["headgrid_core", "flash_core", "attn_core"])
@pytest.mark.parametrize("B,S,causal", SHAPES[1:])
def test_flash_style_control_fails_the_core_bar(name, B, S, causal):
    """The online softmax casts P against a running max: past one key tile
    it rounds P elsewhere and fails the bar the two-pass schedule meets."""
    qkv = _qkv(B, S)
    _, scale_after, defer, _ = FORWARD[name]
    got, want = _forward_pair(name, B, S, causal, None)
    logits = _logits(qkv, S, causal, None, scale_after)
    bad = _merge(flash_forward(logits, _heads(qkv, S)[2]))
    ulps = LONG_ULPS if not defer and S > 512 else CORE_ULPS
    assert _meets(got, want, ulps)[0]
    ok, stats = _meets(bad, want, ulps)
    assert not ok, stats


@pytest.mark.parametrize("sched", ["mha_core_bwd", "attn_core_bwd"])
@pytest.mark.parametrize("B,S,causal", SHAPES)
@pytest.mark.parametrize("with_s_valid", [False, True])
def test_two_pass_backward_meets_the_bwd_bar(sched, B, S, causal, with_s_valid):
    qkv, g = _qkv(B, S), _g(B, S)
    s_valid = S - 7 if with_s_valid else None
    deferred = sched == "attn_core_bwd"
    ctx, dqkv = two_pass_backward(qkv, g, S, causal, s_valid, deferred)
    if deferred:
        want_ctx, want = TB.attn_core_bwd_reference(qkv.reshape(B * S, -1), g.reshape(B * S, -1),
                                                    S, HEADS, causal, s_valid)
        ok, stats = _meets(ctx, want_ctx.reshape(ctx.shape), CORE_ULPS)
        assert ok, ("ctx", stats)
    else:
        want = M.mha_core_bwd_reference(qkv, g, S, HEADS, causal, s_valid)
    ok, stats = _meets(dqkv, want.reshape(dqkv.shape), BWD_ULPS)
    assert ok, ("dqkv", stats)
