"""Plain float32 Qwen3-TTS-12Hz talker, code predictor and text projection.

Recomputes, from the text and the codes a request served, the logits the
served codes were chosen from, teacher-forced: one full causal pass of
the talker over the request's whole input sequence, and one 16-row pass
of the code predictor per frame. Written from the model's description:

- the prompt `<|im_start|>assistant\\n{text}<|im_end|>\\n<|im_start|>assistant\\n`,
  byte ids for the text (the tokenizer stand-in: no tokenizer files) and
  Qwen's ids for the specials; its first three ids are the role;
- text projection: embedding → fc1 → SiLU → fc2;
- talker input: 8 conditioning rows (the role's 3 projected rows; 4 rows of
  projected [tts_pad, tts_pad, tts_pad, tts_bos] plus the codec embeddings
  of [nothink, think_bos, think_eos, codec_pad]; the first content id's
  projected row plus the codec_bos embedding), then the codec_bos
  embedding, then one row a frame: the sum of the frame's 16 codec-group
  embeddings (group 0 from the talker's table, groups 1..15 from the code
  predictor's) plus the frame's trailing text row (the projected content
  ids after the first, then tts_eos, then tts_pad);
- the talker's logits at row 8 + i choose code 0 of frame i (greedy);
- the code predictor's input for frame i: the talker's hidden state at
  row 8 + i, the talker embedding of code 0, then the code predictor's
  embeddings of codes 1..14; its row g chooses code g through head g - 1
  (sampled: top-k, temperature).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import qwen3

IM_START, IM_END, ASSISTANT, NEWLINE = 151644, 151645, 77091, 198
TTS_PAD, TTS_BOS, TTS_EOS = 151671, 151672, 151673
CODEC_PAD, CODEC_BOS, CODEC_EOS = 2148, 2149, 2150
CODEC_NOTHINK, CODEC_THINK_BOS, CODEC_THINK_EOS = 2155, 2156, 2157


def prompt_ids(text: str) -> list[int]:
    """The chat prompt's ids: specials by id, the text as UTF-8 bytes."""
    return ([IM_START, ASSISTANT, NEWLINE] + list(text.encode("utf-8"))
            + [IM_END, NEWLINE, IM_START, ASSISTANT, NEWLINE])


def project(w: dict, ids) -> torch.Tensor:
    """Text ids → `[T, H]` f32 talker rows."""
    emb = w["text.embedding"]
    ids = torch.as_tensor(ids, device=emb.device).clamp(0, emb.shape[0] - 1)
    x = F.silu(emb[ids].float() @ w["text.fc1_w"].float() + w["text.fc1_b"].float())
    return x @ w["text.fc2_w"].float() + w["text.fc2_b"].float()


def talker_inputs(w: dict, text: str, codes: torch.Tensor) -> torch.Tensor:
    """`[8 + 1 + F, H]` f32: conditioning rows, the codec_bos row, and the
    input row of each of the F frames in `codes [F, 16]`."""
    ids = prompt_ids(text)
    role, content = ids[:3], ids[3:]
    n = len(content)
    emb = w["talker.embed"].float()
    tags = project(w, [TTS_PAD, TTS_PAD, TTS_PAD, TTS_BOS]) + emb[
        torch.tensor([CODEC_NOTHINK, CODEC_THINK_BOS, CODEC_THINK_EOS, CODEC_PAD],
                     device=emb.device)]
    first = project(w, content[:1]) + emb[CODEC_BOS]
    rows = [project(w, role), tags, first, emb[CODEC_BOS][None]]
    F_ = codes.shape[0]
    if F_:
        codes = codes.to(emb.device).long()
        groups = torch.arange(codes.shape[1] - 1, device=emb.device)
        sums = emb[codes[:, 0]] + w["cp.codec_embeds"][groups, codes[:, 1:]].float().sum(1)
        trailing = torch.cat([project(w, content[1:n - 5] + [TTS_EOS]),
                              project(w, [TTS_PAD]).expand(max(F_, 1), -1)])
        rows.append(sums + trailing[:F_])
    return torch.cat(rows)


def sample_terms(logits: torch.Tensor, chosen: torch.Tensor, top_k: int,
                 temperature: float) -> torch.Tensor:
    """`[3]` f64: over the sampled codes `chosen` that lie inside the top k
    of their `logits [..., V]`, the sums of s - E[s] and of Var[s], where
    s = -log p(code) under the distribution the model samples from
    (softmax over the top k of logits / temperature), and their count.
    Sampled from that distribution, (sum of s - E[s]) / sqrt(sum of
    Var[s]) is a standard normal draw; another temperature or another
    distribution moves it by a multiple of the square root of the count."""
    vals, idxs = (logits.double() / temperature).topk(top_k, dim=-1)
    logp = vals.log_softmax(-1)
    p = logp.exp()
    mean = -(p * logp).sum(-1)
    var = (p * logp * logp).sum(-1) - mean * mean
    hit = idxs == chosen[..., None]
    inside = hit.any(-1)
    s = -(logp * hit).sum(-1)
    return torch.stack([(s - mean)[inside].sum(), var[inside].sum(),
                        inside.sum().double()])


def request_gaps(w: dict, cfg: dict, text: str, codes: torch.Tensor, ended_by_eos: bool,
                 top_k: int, temperature: float) -> dict:
    """One request's widest gaps: `talker` over every served code 0 (and
    the EOS that ended it), `cp` over every sampled code of groups 1..15:
    how far it lies below the reference's `top_k`-th best logit (0 inside
    the top k); and `sample`, the sampled codes' `sample_terms`."""
    codes = codes.long()
    F_ = codes.shape[0]
    x = talker_inputs(w, text, codes[:F_ if ended_by_eos else F_ - 1])
    hidden = qwen3.forward(w, "talker", cfg["talker"], x[None])[0]
    logits = hidden[8:] @ w["talker.lm_head"].float()            # row 8 + i → frame i
    served = codes[:, 0].to(logits.device)
    if ended_by_eos:
        served = torch.cat([served, served.new_tensor([CODEC_EOS])])
    talker = qwen3.gap(logits[:served.shape[0]], served)

    # code predictor: 16 rows a frame, all frames as one batch
    cpw, emb = w, w["talker.embed"].float()
    dev = logits.device
    c = codes.to(dev)
    rows = [hidden[8:8 + F_][:, None], emb[c[:, 0]][:, None]]
    if c.shape[1] > 2:
        groups = torch.arange(c.shape[1] - 2, device=dev)
        rows.append(cpw["cp.codec_embeds"][groups, c[:, 1:-1]].float())
    cp_hidden = qwen3.forward(w, "cp", cfg["code_predictor"], torch.cat(rows, dim=1))
    heads = w["cp.lm_heads"].float()                                 # [15, H, V]
    cp_logits = torch.einsum("fgh,ghv->fgv", cp_hidden[:, 1:], heads)  # [F, 15, V]
    kth = cp_logits.topk(top_k, dim=-1).values[..., -1]
    chosen = cp_logits.gather(-1, c[:, 1:, None])[..., 0]
    cp = (kth - chosen).clamp_min(0.0)
    return {"talker": float(talker.max()) if talker.numel() else 0.0,
            "cp": float(cp.max()) if cp.numel() else 0.0,
            "sample": sample_terms(cp_logits, c[:, 1:], top_k, temperature).cpu(),
            "frames": F_}
