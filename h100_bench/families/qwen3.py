"""The Qwen3 text LM (`qwen3-0.6b-voice-agent`): a dense Qwen3 decoder whose
head is tied to the embedding, served by the port's `TextLM` on B1's
text-LM form and held to the plain float32 `reference/lm.py`."""

from __future__ import annotations

from .. import check, costs, weights


def lm_config(cfg: dict) -> dict:
    """The text LM's sizes under the decoder keys the reference and the
    cost functions read."""
    return {"num_layers": cfg["num_hidden_layers"], "hidden_size": cfg["hidden_size"],
            "intermediate_size": cfg["intermediate_size"],
            "num_q_heads": cfg["num_attention_heads"],
            "num_kv_heads": cfg["num_key_value_heads"], "head_dim": cfg["head_dim"],
            "vocab_size": cfg["vocab_size"], "rope_theta": cfg["rope_theta"],
            "rms_eps": cfg["rms_norm_eps"], "max_seq_len": cfg["max_position_embeddings"]}


def make_weights(cfg: dict, seed: int, device) -> dict:
    return weights.make_lm(cfg, seed, device)


def build(run, w: dict):
    """`TextLM` on the "mega" backend (B1) on the card, "dense" on the CPU;
    under `--control` the configuration's quantized weights and cache."""
    from qwen_tts_tpu_torch.core.config import DecoderConfig
    from qwen_tts_tpu_torch.core.weights import QUANTIZERS
    from qwen_tts_tpu_torch.models.text_lm import TextLM

    lc, dev = run.lm_cfg, run.device
    dc = DecoderConfig(num_layers=lc["num_layers"], hidden_size=lc["hidden_size"],
                       intermediate_size=lc["intermediate_size"], num_q_heads=lc["num_q_heads"],
                       num_kv_heads=lc["num_kv_heads"], head_dim=lc["head_dim"],
                       vocab_size=lc["vocab_size"], max_seq_len=lc["max_seq_len"],
                       rope_theta=lc["rope_theta"], rms_eps=lc["rms_eps"])
    pw = weights.program_lm(w, dc, dev)
    kv = "bf16"
    if run.control:
        low = run.cfg["control"]["lm"]
        pw, kv = QUANTIZERS[low["quantize"]](pw), low["kv_cache"]
    impl = "mega" if dev.type == "cuda" else "dense"
    return TextLM(pw, dc, attn_impl=impl, kv_cache=kv, device=dev)


def check_numbers(w: dict, cfg: dict, replies: list, plan: dict, seed: int) -> dict:
    from ..reference import lm

    return check.lm_numbers(replies, plan, seed,
                            lambda prompt, reply, stop: lm.reply_gaps(w, cfg, prompt, reply, stop))


def token_flops(cfg: dict, pos: float) -> float:
    """One reply id at position `pos`: a decode step with its head."""
    return costs.step_cost(cfg, pos, with_head=True)[1]


def prefill_flops(cfg: dict, P: int) -> float:
    """A `P`-id prompt's prefill: 2 FLOPs a layer weight a row."""
    return 2 * P * cfg["num_layers"] * costs.layer_params(cfg)


def b1_step_cost(cfg: dict, pos: float) -> tuple[float, float]:
    return costs.step_cost(cfg, pos, True)
