"""K2's ``col_sum`` as the Hopper kernel plans and orders its sums, emulated
in plain PyTorch on the CPU.

``ops.attention_bwd.col_sum_plan`` cuts ``[R, C]`` into column strips and
row splits (``csrc/attention_sublayer_bwd.cu``: ``col_sum_kernel``). A
thread's ``ty`` row lanes each add every ``ty``-th row of a split in order,
the block adds its lanes in order, and the last block of a strip adds the
splits' sums in index order: a fixed order of fp32 adds, so a rerun gives
the same bits. The emulation repeats that order exactly (fp32 adds of the
same values in the same order) and must meet the bars of a summed leaf
(``_assert_sum_close`` of ``tests/test_torch_cuda.py``) against
``col_sum_reference``: fp32 allclose atol 1e-4 of the leaf's RMS, rtol 1e-4;
bf16 inputs also cosine >= 0.999, atol 3e-2 of the RMS, rtol 1e-2. The plan
itself is checked to cover every row once, to stay within the kernel's
limits and to put blocks on every SM at the training steps' shapes.

Inputs are made with numpy from a seed."""

import numpy as np
import pytest
import torch

from plip_tpu_torch.ops import attention_bwd as TB


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread: under the suite's parallel workers the
    default threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMS = TB.H100_SMS
BF16 = torch.bfloat16


def emulated_col_sum(t: torch.Tensor, plan: TB.ColSumPlan) -> torch.Tensor:
    """fp32 column sums of ``t [R, C]`` in the kernel's order: lane y of split
    s adds rows ``s * split_rows + y + k * ty`` for k = 0, 1, ... in order;
    the lanes are added in order of y, then the splits in index order."""
    R, C = t.shape
    ty, rows, splits = plan.ty, plan.split_rows, plan.splits
    steps = -(-rows // ty)
    x = torch.zeros(splits * steps * ty, C)
    x[:R] = t.float()
    x = x.view(splits, steps, ty, C)  # row s * rows + k * ty + y (zero past R)
    lanes = torch.zeros(splits, ty, C)
    for k in range(steps):
        lanes = lanes + x[:, k]
    block = lanes[:, 0]
    for y in range(1, ty):
        block = block + lanes[:, y]
    out = block[0]
    for s in range(1, splits):
        out = out + block[s]
    return out


def _assert_sum_bars(got, want, dtype):
    rms = want.square().mean().sqrt().item()
    torch.testing.assert_close(got, want, atol=1e-4 * rms, rtol=1e-4)
    if dtype == BF16:
        cos = torch.nn.functional.cosine_similarity(got, want, dim=-1).item()
        assert cos >= 0.999, cos
        torch.testing.assert_close(got, want, atol=3e-2 * rms, rtol=1e-2)


def _tensor(R, C, dtype, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((R, C), dtype=np.float32)).to(dtype)


# R and C: short stacks (the TN slices) to the LN partials' 2,056 rows,
# ragged and aligned widths; millions of columns only where the path has
# them, with few rows
SHAPES = ([(R, C) for R in (1, 3, 8, 9, 1600, 2056) for C in (5, 24, 768, 2304)]
          + [(R, 3 * 2 ** 20) for R in (1, 3, 8)])


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("R,C", SHAPES)
def test_planned_sum_order_meets_the_bars(R, C, dtype):
    t = _tensor(R, C, dtype, seed=R * 7 + C)
    plan = TB.col_sum_plan(R, C, t.element_size(), 0, SMS)
    _assert_sum_bars(emulated_col_sum(t, plan), TB.col_sum_reference(t), dtype)


@pytest.mark.parametrize("R,C,itemsize,address", [
    (2056, 2048, 4, 0), (1600, 2304, 2, 0), (1600, 2304, 2, 2), (9, 5, 2, 0),
    (16448, 3072, 2, 0), (2, 3 * 2 ** 20, 4, 0), (1601, 2308, 2, 8)])
def test_plan_covers_every_row_once(R, C, itemsize, address):
    """Small integers sum exactly in fp32: the emulated plan gives the exact
    column sums, so it reads every row once (also for a base the kernel
    reads in narrower chunks)."""
    plan = TB.col_sum_plan(R, C, itemsize, address, SMS)
    rows = torch.arange(R, dtype=torch.float32)[:, None] % 7
    t = (rows + torch.arange(min(C, 64), dtype=torch.float32)[None, :] % 5).repeat(
        1, -(-C // 64))[:, :C]
    torch.testing.assert_close(emulated_col_sum(t, plan), t.double().sum(0).float(),
                               atol=0, rtol=0)


# (rows, columns, bytes an element) of every col_sum call of the three
# training steps of PERF.md section 5, and the step-15 shapes of chip_smoke.py
STEP_CALLS = [(1600, 2304, 2), (6400, 768, 2), (6400, 2304, 2), (6400, 3072, 2),
              (800, 1536, 4), (9856, 1536, 2), (9856, 512, 2), (9856, 2048, 2),
              (1232, 1024, 4), (16448, 3072, 2), (16448, 1024, 2), (2056, 2048, 4),
              (4928, 2304, 2), (616, 1536, 4), (2, 1024 * 3072, 4), (3, 768 * 2304, 4),
              (7, 512 * 512, 4), (1600, 768, 2)]


@pytest.mark.parametrize("R,C,itemsize", STEP_CALLS)
def test_plan_stays_within_the_kernel(R, C, itemsize):
    """The plan the kernel is given: 16-byte loads where C allows, a power of
    two of row lanes up to COL_SUM_ROWS, each lane of a split with at least
    COL_SUM_UNROLL rows, at most COL_SUM_MAX_SPLITS splits covering R, and
    for a split plan no more strips than the counters it shares."""
    plan = TB.col_sum_plan(R, C, itemsize, 0, SMS)
    assert plan.vec == 16 // itemsize
    assert plan.ty & (plan.ty - 1) == 0 and plan.ty <= TB.COL_SUM_ROWS
    assert 1 <= plan.splits <= TB.COL_SUM_MAX_SPLITS
    assert (plan.splits - 1) * plan.split_rows < R <= plan.splits * plan.split_rows
    strip = TB.COL_SUM_THREADS // plan.ty * plan.vec
    assert plan.strips == -(-C // strip)
    if plan.splits > 1:
        assert plan.split_rows >= plan.ty * TB.COL_SUM_UNROLL
        assert plan.strips <= TB.COL_SUM_BLOCKS_PER_SM * SMS


@pytest.mark.parametrize("R", [32 * 50, 128 * 50])
def test_plan_fills_the_card_at_dbout(R):
    """ViT-B/32's dbout (W=768, 12 strips of 64 columns) at batch 32 and 128:
    row splits bring the grid past one block an SM (the kernel before took 24
    blocks for it, one per 32 columns)."""
    plan = TB.col_sum_plan(R, 768, 2, 0, SMS)
    assert plan.strips == 12
    assert plan.strips * plan.splits >= SMS


@pytest.mark.parametrize("R,C,itemsize", [(16448, 3072, 2), (6400, 3072, 2),
                                          (2, 1024 * 3072, 4), (9856, 1536, 2)])
def test_plan_puts_several_blocks_on_every_sm(R, C, itemsize):
    """The large calls (L/14 dbqkv, B/32 db1, a TN slice stack, the text
    tower's dbqkv) get at least three blocks an SM."""
    plan = TB.col_sum_plan(R, C, itemsize, 0, SMS)
    assert plan.strips * plan.splits >= 3 * SMS


@pytest.mark.parametrize("C,address,itemsize,vec", [
    (2304, 0, 2, 8), (2304, 2, 2, 1), (2304, 4, 2, 2), (2308, 0, 2, 4), (5, 0, 2, 1),
    (2048, 0, 4, 4), (2048, 8, 4, 2), (1026, 0, 4, 2)])
def test_plan_narrows_the_load_for_c_and_the_base(C, address, itemsize, vec):
    assert TB.col_sum_plan(64, C, itemsize, address, SMS).vec == vec


def test_col_sum_on_the_cpu_launches_nothing():
    t = _tensor(40, 24, BF16, seed=1)
    TB.reset_launch_counts()
    got = TB.col_sum(t)
    assert got.dtype == torch.float32 and TB.LAUNCHES["col_sum"] == 0
    torch.testing.assert_close(got, t.float().sum(0))
