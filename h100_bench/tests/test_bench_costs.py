"""The byte and FLOP counts behind the rooflines and `model_mfu`, by hand
at small shapes, and the frozen `step_cost` against the one it was copied
from."""

import json
from pathlib import Path

import pytest
import torch

from h100_bench import costs, weights
from h100_bench.families import qwen3

C = {"num_layers": 2, "hidden_size": 4, "intermediate_size": 6, "num_q_heads": 2,
     "num_kv_heads": 1, "head_dim": 2, "vocab_size": 10}
C2W = {"hidden_size": 4, "num_attention_heads": 2, "num_key_value_heads": 2,
       "intermediate_size": 6, "sliding_window": 72, "num_hidden_layers": 1,
       "upsampling_ratios": [2], "upsample_rates": [2], "decoder_dim": 4}


def test_step_cost_by_hand():
    # 120 weights a layer; norms 2 * (2*4 + 2*2) + 4 = 28 bf16; head 4 x 10
    assert costs.layer_params(C) == 4 * 8 + 4 * 4 + 4 * 12 + 6 * 4 == 120
    nbytes, flops = costs.step_cost(C, 3, with_head=True)
    assert nbytes == (2 * 120 * 2 + 28 * 2 + 80) + 2 * 2 * 1 * 3 * 4 + (16 + 32 + 40) == 752
    assert flops == 2 * 2 * 120 + 2 * 4 * 10 + 4 * 2 * 2 * 4 * 2 == 688
    assert costs.step_cost(C, 3, with_head=False) == (752 - 80 - 40, 688 - 80)
    assert qwen3.token_flops(C, 3) == 688 and qwen3.b1_step_cost(C, 3) == (752, 688)
    assert qwen3.prefill_flops(C, 5) == 2 * 5 * 2 * 120


def test_attention_cost_by_hand():
    # per slot: K and V prefix 2 * 1 * p * 2 dims * 2 B, q/k/v/out (2*2 + 2*1) * 2 * 4 B
    assert costs.attention_cost(C, [3, 5]) == (24 + 48 + 40 + 48, 4 * 2 * 4 * 2 + 4 * 2 * 6 * 2)


def test_code2wav_flops_by_hand():
    macs = 3 * 4 * (12 + 4 + 18) + 2 * 3 * 3 * 2 * 2          # transformer, 3 frames
    macs += 4 * 4 * 2 * 3 + 4 * 7 * 6 + 8 * 16 * 6              # x2 up, ConvNeXt at 6
    macs += 4 * 4 * 7 * 6                                        # pre conv
    macs += 4 * 2 * 2 * 2 * 6 + 3 * (4 * 7 + 4) * 10             # block: up to 10, units
    assert costs.code2wav_flops(C2W, 3) == 2.0 * (macs + 2 * 7 * 10) == 6952.0


def test_bound_is_the_slower_of_bytes_and_flops():
    assert costs.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert costs.bound_s(0, 989e12) == pytest.approx(1.0)
    assert costs.bound_s(3.35e12, 2 * 989e12) == pytest.approx(2.0)


def test_frozen_step_cost_equals_the_smoke_test_one():
    import chip_smoke

    from h100_bench.entries.common import model_config

    cfg = json.loads((Path(__file__).parent / "tiny-tts.json").read_text())
    mc = model_config(cfg)
    w = weights.program_tts(weights.make_tts(cfg, 3, "cpu"), mc, torch.device("cpu"))
    for pos in (0, 17, 300):
        for head in (True, False):
            assert costs.step_cost(cfg["talker"], pos, head) == chip_smoke.step_cost(
                mc.talker, w.talker, pos, head)
