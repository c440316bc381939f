"""The int8 GEMM's launch plan (``ops/int8_gemm.py int8_gemm_plan``) on
the CPU: shape arithmetic only, the same that the wrapper hands the CUDA
kernels (``ops/csrc/int8_gemm.cu``) on the card, for an H100 SXM's 132
SMs and its co-resident clusters (``resident_model``)."""

import pytest
import torch

from dynamo_tpu_torch.ops import int8_gemm
from dynamo_tpu_torch.ops.int8_gemm import (INT8_GEMM_ROUTES, MAX_SPLITS,
                                            WG_TILE_N, WG_TOKENS, Int8Plan,
                                            int8_gemm_plan, resident_model)

SMS = 132
# the 8B model's projections (K, N): wq and wo, wk and wv, w_gate and
# w_up, w_down, lm_head; and one rank's at tp=2
SHAPES = {"wq_wo": (4096, 4096), "wk_wv": (4096, 1024),
          "gate_up": (4096, 14336), "down": (14336, 4096),
          "lm_head": (4096, 128256)}
TP2_SHAPES = {"wq": (4096, 2048), "wk_wv": (4096, 512),
              "gate_up": (4096, 7168), "lm_head": (4096, 64128),
              "wo": (2048, 4096), "down": (7168, 4096)}
SERVED = sorted(SHAPES.items()) + sorted(
    (f"tp2 {k}", v) for k, v in TP2_SHAPES.items())
ROWS = (1, 4, 16, 24, 32, 48, 64, 512, 4096)
# the route each served shape takes at few rows, as measured at tp=1 and
# tp=2 (PERF.md, Findings): small_m up to 16 rows everywhere, and up to
# 32 rows of the shapes whose small-M route is faster there (N <= 4,096;
# w_gate/w_up and lm_head take wgmma from 17 rows)
NARROW = {"wq_wo", "wk_wv", "down", "tp2 wq", "tp2 wk_wv", "tp2 wo",
          "tp2 down"}


def _resident(tokens, splits):
    return resident_model(tokens, splits, SMS)


def _valid(plan: Int8Plan, M: int, N: int, K: int) -> None:
    """What the C entry takes for the route, and a grid that covers every
    tile of M x N."""
    assert plan.route in INT8_GEMM_ROUTES
    if plan.route == "small_m":
        assert plan.tile in (1, 2) and M <= 16 * plan.tile
        assert 1 <= plan.splits <= MAX_SPLITS
        tiles = -(-N // int8_gemm.SMALL_TILE_N)
        assert plan.grid == tiles * plan.splits
        # every split has a stage of K for each of the block's K groups,
        # and the tiles' clusters fit the card one block an SM
        stages = -(-K // int8_gemm.SMALL_STAGE_K)
        assert (plan.splits == 1 or -(-stages // plan.splits)
                >= int8_gemm.SMALL_MIN_STAGES)
        assert plan.splits == 1 or tiles <= _resident(16, plan.splits)
        return
    assert plan.route == "wgmma"
    assert plan.tile in WG_TOKENS
    assert plan.splits in (1, 2, 4, 8)
    assert plan.grid % plan.splits == 0
    clusters = plan.grid // plan.splits
    tiles = -(-M // plan.tile) * -(-N // WG_TILE_N)
    # the persistent clusters walk every tile, and the card holds them all
    assert 1 <= clusters <= min(tiles, _resident(plan.tile, plan.splits))


@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("name,shape", SERVED)
def test_served_shapes_take_the_measured_route(name, shape, M):
    """Every served bf16 shape goes to the route the measured crossover
    names: small_m up to 16 rows of every product and up to 32 rows of
    wq, wo, wk, wv and w_down (at tp=1 and tp=2); wgmma for the rest."""
    K, N = shape
    plan = int8_gemm_plan(M, N, K, SMS)
    small = M <= 16 or (M <= 32 and name in NARROW)
    assert plan.route == ("small_m" if small else "wgmma")
    _valid(plan, M, N, K)


@pytest.mark.parametrize("name,shape", SERVED)
def test_every_row_count_has_a_plan(name, shape):
    """M = 1 .. 8,192 rows: each takes a valid launch, with no gap
    between the routes."""
    K, N = shape
    for M in range(1, 8193):
        _valid(int8_gemm_plan(M, N, K, SMS), M, N, K)


# the share of the SMs the blocks of a served call must occupy: the
# planner may leave a few idle where one more split would cost a second
# round of tiles (w_gate's 112 tiles of 32 rows: 26.3 us on 112 blocks,
# 32.2 us with two splits on an H100, PERF.md)
FILL = 0.8


@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("name,shape", SERVED)
def test_blocks_fill_the_card(name, shape, M):
    """The blocks fill the card at every served shape: at least FILL of
    the SMs busy, unless the splits reached their cap (small_m: no more
    splits give a block fewer stages while keeping SMALL_MIN_STAGES a
    split and every tile's cluster on the card one block an SM; wgmma:
    MAX_SPLITS, two chunks a split, or as many as let every tile's
    cluster be on the card at once)."""
    K, N = shape
    plan = int8_gemm_plan(M, N, K, SMS)
    chunks = -(-K // 64)
    if plan.route == "small_m":
        stages = -(-K // int8_gemm.SMALL_STAGE_K)
        tiles = -(-N // int8_gemm.SMALL_TILE_N)
        capped = not any(
            -(-stages // s) < -(-stages // plan.splits)
            and -(-stages // s) >= int8_gemm.SMALL_MIN_STAGES
            and tiles <= _resident(16, s)
            for s in range(plan.splits + 1, MAX_SPLITS + 1))
    else:
        tiles = -(-M // plan.tile) * -(-N // WG_TILE_N)
        capped = (plan.splits == MAX_SPLITS or chunks < 4 * plan.splits
                  or _resident(plan.tile, 2 * plan.splits) < tiles)
    assert plan.grid >= FILL * SMS or capped, plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("M,K,N", [(1, 64, 64), (4, 64, 192),
                                   (512, 128, 64), (4096, 4096, 4096)])
def test_float32_and_float16_take_the_simt_route(dtype, M, K, N):
    """Neither float32 nor float16 x takes the simt route any more (it is
    gone): float16 x takes the bfloat16 plan (small_m or wgmma), float32 x
    the float32 forms of the same two routes, by its own crossover and
    time model."""
    plan = int8_gemm_plan(M, N, K, SMS, dtype)
    assert plan.route in INT8_GEMM_ROUTES == ("small_m", "wgmma")
    if dtype == torch.float32:
        small = M <= int8_gemm.SMALL_M_ROWS_F32
        assert plan.route == ("small_m" if small else "wgmma")
        if small:
            assert plan == int8_gemm.small_m_plan(M, N, K, SMS, _resident,
                                                  dtype)
            assert plan.tile == -(-M // 8)
        else:
            assert plan == int8_gemm.wgmma_plan(M, N, K, _resident, dtype)
            assert plan.tile in int8_gemm.WG_TOKENS_F32
    else:
        assert plan == int8_gemm_plan(M, N, K, SMS, torch.bfloat16)
        assert plan.route in ("small_m", "wgmma")


def test_resident_model_is_the_h100s():
    """The CUDA driver's counts on an H100 SXM, at every tile width and
    cluster size."""
    for tokens in WG_TOKENS:
        assert [resident_model(tokens, s, SMS) for s in range(1, 9)] == \
            [132, 66, 39, 30, 22, 17, 15, 15]


def test_small_m_plan_uses_the_cards_resident_count():
    """The small-M plan splits K only as far as every tile's cluster fits
    the card one block an SM: a card that holds fewer clusters gets fewer
    splits."""
    assert int8_gemm_plan(4, 1024, 4096, SMS) == ("small_m", 1, 6, 96)
    few = int8_gemm_plan(4, 1024, 4096, SMS,
                         resident=lambda tokens, splits: 16 // splits)
    assert few == ("small_m", 1, 1, 16)
    half = int8_gemm_plan(4, 1024, 4096, SMS,
                          resident=lambda tokens, splits: 16)
    assert half == ("small_m", 1, 8, 128)


def test_plan_uses_the_cards_resident_count():
    """The wrapper hands the plan the CUDA driver's count of co-resident
    clusters; a card that holds fewer gets a smaller grid."""
    few = int8_gemm_plan(4096, 4096, 4096, SMS,
                         resident=lambda tokens, splits: 7)
    assert few.route == "wgmma" and few.grid == 7 * few.splits
