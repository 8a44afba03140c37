"""The yardstick's arithmetic: tails and rates over all samples, the spread,
the kernels' operations and bytes at the cells' shapes (worked by hand),
the model FLOPs."""

import json
import statistics
from types import SimpleNamespace

import numpy as np
import pytest

from perfbench import readers
from perfbench.roofline import (PEAK_BYTES, PEAK_FLOPS, ModelFlops,
                                bound_seconds, decode_attn_cost,
                                moe_gmm_cost)
from perfbench.stats import percentile, spread
from perfbench.tests.tiny import ROOT


@pytest.mark.parametrize("q", [50.0, 95.0, 99.0])
def test_percentile_is_numpys_linear_rule(q):
    xs = np.random.default_rng(0).exponential(size=301)
    assert percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [10.0, 11.0, 9.5, 10.4, 12.0, 10.1]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert spread(xs) == pytest.approx((q3 - q1) / med)


def _req(times, due, in_window=True):
    return SimpleNamespace(times=times, due=due, in_window=in_window,
                           prompt_len=8)


def _run(records, t0=0.0, seconds=10.0, steps=((0.0, 12.0, 0),)):
    return SimpleNamespace(records=records, t0=t0, seconds=seconds,
                           steps=list(steps),
                           window=[r for r in records if r.in_window])


def test_tails_take_every_sample_and_late_requests():
    # 20 requests with a TTFT of 10 ms, one with 1 s, one never served
    recs = [_req([i + 0.01, i + 0.02], i) for i in range(20)]
    recs.append(_req([5.0 + 1.0, 5.0 + 1.5], 5.0))
    recs.append(_req([], 9.0))                      # waited until 12 s
    recs.append(_req([0.5], 0.0, in_window=False))  # not in the window
    run = _run(recs)
    ttft = readers.ttft_s(run)
    assert len(ttft) == 22
    assert sorted(ttft)[-2:] == pytest.approx([1.0, 3.0])
    assert readers.tail_ms(ttft) == pytest.approx(
        1e3 * percentile(ttft, 95))
    gaps = readers.itl_s(run)
    assert len(gaps) == 21 and max(gaps) == pytest.approx(0.5)
    # the tail's mean: the gaps at or above the 95th percentile
    cut = percentile(gaps, 95)
    top = [g for g in gaps if g >= cut]
    assert readers.tail_mean_ms(gaps, 95) == pytest.approx(
        1e3 * sum(top) / len(top))
    assert readers.tail_mean_ms(gaps, 95) >= readers.tail_ms(gaps, 95)


def test_rate_counts_every_token_in_the_window():
    recs = [_req([0.5, 1.0, 9.9, 10.5], 0.0),
            _req([2.0, 3.0], 1.0, in_window=False)]
    run = _run(recs)
    assert readers.tokens_in_window(run) == 5
    assert readers.tokens_in_window(run) / run.seconds == 0.5


def test_moe_gmm_cost_at_the_cells_shapes():
    # phi3.5 decode: 16 experts, 32 rows x top-2 = 64 routed rows over
    # 10 live experts, d 4096, F 6400, bf16
    gs = [8, 7, 0, 9, 6, 0, 6, 0, 7, 5, 0, 6, 0, 4, 0, 6]
    assert sum(gs) == 64 and sum(g > 0 for g in gs) == 10
    flops, nbytes = moe_gmm_cost(4096, 6400, gs, 2)
    assert flops == 6 * 64 * 4096 * 6400 == 10_066_329_600
    assert nbytes == (10 * 3 * 4096 * 6400 + 2 * 64 * 4096) * 2
    assert nbytes == 1_573_912_576
    # bound by bytes: 0.4698 ms at 3.35 TB/s
    assert bound_seconds(flops, nbytes) == pytest.approx(
        nbytes / PEAK_BYTES)
    assert bound_seconds(flops, nbytes) == pytest.approx(4.6982e-4,
                                                         rel=1e-4)
    # DeepSeek-V3 decode: 256 experts, 64 rows x top-8, all rows on 200
    # live experts, d 7168, F 2048
    gs = [3] * 112 + [2] * 88 + [0] * 56
    assert sum(gs) == 512
    flops, nbytes = moe_gmm_cost(7168, 2048, gs, 2)
    assert flops == 6 * 512 * 7168 * 2048
    assert nbytes == (200 * 3 * 7168 * 2048 + 2 * 512 * 7168) * 2
    # phi3.5's prefill buckets: 1024 tokens (128 rows an expert) are
    # bound by bytes, 4096 tokens (512 rows) by operations; the two meet
    # at 989 / 3.35 = 295 rows an expert
    flops, nbytes = moe_gmm_cost(4096, 6400, [128] * 16, 2)
    assert flops / PEAK_FLOPS < nbytes / PEAK_BYTES
    flops, nbytes = moe_gmm_cost(4096, 6400, [512] * 16, 2)
    assert flops / PEAK_FLOPS > nbytes / PEAK_BYTES


def test_decode_attn_cost_at_the_cells_shapes():
    # phi3.5: 32 heads over 8 kv heads of 128, bf16, rows at 1500 and
    # 2000 live positions
    flops, nbytes = decode_attn_cost(32, 8, 128, [1500, 2000], 2)
    assert flops == 4 * 3500 * 32 * 128 == 57_344_000
    assert nbytes == (2 * 3500 * 8 * 128 + 2 * 2 * 32 * 128) * 2
    assert nbytes == 14_368_768


def _port(name):
    conf = json.loads((ROOT / "perfbench" / "configs"
                       / f"{name}.json").read_text())
    return conf["port"]


def test_model_flops_by_hand():
    phi = ModelFlops(_port("phi3.5-moe-16l"))
    attn = 2 * 4096 * 32 * 128 + 2 * 4096 * 8 * 128        # q, o; k, v
    moe = 4096 * 16 + 2 * 3 * 4096 * 6400                  # router, 2 of 16
    assert phi.matmul_params == 16 * (attn + moe) + 4096 * 32064
    assert phi.decode(99) == pytest.approx(
        2 * phi.matmul_params + 2 * 16 * 32 * 256 * 100)
    assert phi.prefill(3) == pytest.approx(
        3 * 2 * phi.matmul_params + 16 * 32 * 256 * (1 + 2 + 3) * 2)
    ds = ModelFlops(_port("deepseek-v3-5l"))
    mla = (7168 * 1536 + 1536 * 128 * 192 + 7168 * 576
           + 512 * 128 * 256 + 128 * 128 * 7168)
    dense = 3 * 7168 * 18432
    moe = 7168 * 256 + 8 * 3 * 7168 * 2048 + 3 * 7168 * 2048
    assert ds.matmul_params == (5 * mla + 3 * dense + 2 * moe
                                + 7168 * 129280)
    assert ds.attn_width == 128 * (192 + 128)


def test_config_files_agree_with_what_the_program_runs():
    """The published keys the files keep match their ``port`` sections."""
    for name, keys in (
            ("phi3.5-moe-16l", {"hidden_size": "d_model",
                               "num_attention_heads": "n_heads",
                               "num_key_value_heads": "n_kv_heads",
                               "num_hidden_layers": "n_layers",
                               "vocab_size": "vocab"}),
            ("deepseek-v3-5l", {"hidden_size": "d_model",
                                "num_attention_heads": "n_heads",
                                "num_hidden_layers": "n_layers",
                                "vocab_size": "vocab"})):
        conf = json.loads((ROOT / "perfbench" / "configs"
                           / f"{name}.json").read_text())
        for hf, port in keys.items():
            assert conf[hf] == conf["port"][port], (name, hf)
        moe = conf["port"]["moe"]
        # every token kept: capacity_factor = experts / top-k
        assert moe["capacity_factor"] * moe["top_k"] == moe["n_experts"]
    ds = json.loads((ROOT / "perfbench" / "configs"
                     / "deepseek-v3-5l.json").read_text())
    assert ds["port"]["moe"]["d_ff"] == ds["moe_intermediate_size"]
    assert ds["port"]["moe"]["dense_d_ff"] == ds["intermediate_size"]
    assert ds["port"]["mla"]["kv_lora_rank"] == ds["kv_lora_rank"]
    assert ds["port"]["moe"]["first_dense_layers"] == \
        ds["first_k_dense_replace"]
