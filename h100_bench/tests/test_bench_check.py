"""`cp_sample_z`: the sampled codes against the distribution they should be
drawn from. Codes drawn from it give a standard normal z; codes drawn at
another temperature, or greedily, give one that grows with the square
root of their count."""

import pytest
import torch

from h100_bench.reference.tts import sample_terms


def z_of(logits, chosen, top_k=50, temperature=0.9):
    s, v, n = sample_terms(logits, chosen, top_k, temperature)
    return float(s / v.sqrt()), int(n)


def draw(logits, top_k, temperature, gen):
    vals, idxs = (logits / temperature).topk(top_k, dim=-1)
    pick = torch.multinomial(vals.softmax(-1), 1, generator=gen)
    return idxs.gather(-1, pick)[..., 0]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_codes_drawn_from_the_distribution_read_a_standard_normal(seed):
    gen = torch.Generator().manual_seed(seed)
    logits = torch.randn(6000, 2048, generator=gen)
    z, n = z_of(logits, draw(logits, 50, 0.9, gen))
    assert n == 6000 and abs(z) < 4.0


@pytest.mark.parametrize("temperature", [1.2, 0.6])
def test_another_temperature_reads_far_out(temperature):
    gen = torch.Generator().manual_seed(5)
    logits = torch.randn(6000, 2048, generator=gen)
    z, _n = z_of(logits, draw(logits, 50, temperature, gen))
    assert abs(z) > 8.0


def test_greedy_codes_read_far_below_and_codes_outside_the_top_k_are_left_out():
    gen = torch.Generator().manual_seed(6)
    logits = torch.randn(3000, 2048, generator=gen)
    assert z_of(logits, logits.argmax(-1))[0] < -20.0
    worst = logits.argmin(-1)
    assert z_of(logits, worst)[1] == 0
