"""The rank side of `tests/test_torch_sharding.py`: what each of 8 gloo
ranks computes on the port's (dp, tp) meshes. A plain module (not a test
file), importable by the spawned ranks: it imports neither JAX nor the test
module. The inputs come from the parent through a file (`torch.save`); each
rank returns its results to the parent (`parallel/launch.py::run_ranks`)."""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from qwen_tts_tpu_torch.core.config import tiny_test_config
from qwen_tts_tpu_torch.core.weights import QUANTIZERS
from qwen_tts_tpu_torch.engine.tts_engine import TTSConfig, TTSEngine
from qwen_tts_tpu_torch.models.code_predictor import cp_predict
from qwen_tts_tpu_torch.models.decoder import decode_step, decode_step_with_embed, init_state
from qwen_tts_tpu_torch.parallel.mesh import axis, make_mesh
from qwen_tts_tpu_torch.parallel.sharding import (
    local_config,
    shard_cp_weights,
    shard_decoder_weights,
    tensor_parallel,
)
from qwen_tts_tpu_torch.runtime.batch import batched_frames, batched_prefill

TEXTS = ["hello world", "a longer second utterance for the batch", "third",
         "and a fourth one"]


def quantized_frames(mc, w, inp, rows: slice):
    """JAX's served quantized tier (int8 talker and code predictor with a
    bf16 CP head, int8 KV) through the batched frame path, for the slots
    `rows` of the inputs. Returns numpy (tok0, hid0, codes, valid)."""
    qt = QUANTIZERS["int8"](w.talker)
    qcp = w.code_predictor._replace(decoder=QUANTIZERS["int8"](w.code_predictor.decoder,
                                                               quant_head=False))
    pre, tr = inp["prefill"][rows], inp["trailing"][rows]
    B = pre.shape[0]
    st, tok0, hid0 = batched_prefill(mc.talker, qt, pre, kv_dtype=torch.int8)
    _, codes, valid, _, _ = batched_frames(
        mc.talker, mc.code_predictor, qt, qcp, st, tok0, hid0, tr, inp["tlen"][rows],
        torch.zeros(B, dtype=torch.int32), inp["pad"], inp["uniform"][rows],
        num_frames=inp["uniform"].shape[1])
    return tuple(x.numpy() for x in (tok0, hid0, codes, valid))


def world8(rank: int, path: str) -> dict:
    inp = torch.load(path, weights_only=False)
    cfg, w = inp["cfg"], inp["decoder"]
    out = {}

    m24 = make_mesh(dp=2, tp=4, device_type="cpu")
    out["mesh"] = (tuple(m24.shape), m24.mesh_dim_names, tuple(axis(m24, "dp")[:2]),
                   tuple(axis(m24, "tp")[:2]))
    try:
        make_mesh(dp=3, tp=3, device_type="cpu")
    except ValueError as e:
        out["mesh_3x3"] = str(e)

    # tp = 8: one step from token 7 on a fresh cache
    m18 = make_mesh(dp=1, tp=8, device_type="cpu")
    lcfg = local_config(cfg, m18)
    st, tok, hid = decode_step(lcfg, shard_decoder_weights(m18, w), init_state(lcfg, "cpu"),
                               torch.tensor([7]), tp=tensor_parallel(m18))
    out["tp8"] = (int(tok), hid.numpy(), tuple(st.k_cache.shape))

    # the code predictor's frame, tp = 8, greedy
    cpw = inp["cp"]
    ccfg = local_config(inp["cp_cfg"], m18)
    out["cp_tp8"] = cp_predict(ccfg, shard_cp_weights(m18, cpw), inp["cp_hidden"],
                               torch.tensor(5), inp["cp_embed"], do_sample=False,
                               tp=tensor_parallel(m18)).numpy()

    # dp x tp = (2, 4): a batched step of B = 4 slots, B/dp a rank
    dp = axis(m24, "dp")
    lcfg = local_config(cfg, m24)
    n = len(inp["tokens"]) // dp.size
    toks = inp["tokens"][dp.index * n:(dp.index + 1) * n]
    st = init_state(lcfg, "cpu", slots=n)
    st, tok, hid = decode_step_with_embed(lcfg, shard_decoder_weights(m24, w), st,
                                          w.embed[toks].float(), tp=tensor_parallel(m24))
    out["dp2tp4"] = (dp.index, tok.numpy(), hid.numpy(), tuple(st.k_cache.shape))

    # the quantized tier's batched frames, dp-sharded on (4, 2), weights whole
    m42 = make_mesh(dp=4, tp=2, device_type="cpu")
    mc, tts = inp["mc"], inp["tts"]
    dp = axis(m42, "dp")
    n = inp["prefill"].shape[0] // dp.size
    rows = slice(dp.index * n, (dp.index + 1) * n)
    out["qframes"] = (dp.index, quantized_frames(mc, tts, inp, rows),
                      quantized_frames(mc, tts, inp, rows)[2])

    # synthesize_batch(mesh=) on (4, 2)
    # frames capped at 12 a text: the mesh's contract, not the length, is under test
    eng = TTSEngine(TTSConfig(device="cpu", max_seq_len=256, chunk_frames=4, seed=0,
                              backend="dense", max_new_tokens=12),
                    model_config=tiny_test_config(max_seq_len=256))
    eng.initialize(weights=tts)
    results = eng.synthesize_batch(TEXTS, mesh=m42)
    counted = (eng._requests, eng.get_metrics()["frames_generated"])
    n = len(TEXTS) // dp.size
    eng._requests = dp.index * n               # the same request numbers, one process
    alone = eng.synthesize_batch(TEXTS[dp.index * n:(dp.index + 1) * n])
    try:
        eng.synthesize_batch(TEXTS[:3], mesh=m42)
    except ValueError as e:
        out["divisible"] = (str(e), eng._requests)
    out["synth"] = (dp.index, [(np.asarray(a), sr) for a, sr in results],
                    [(np.asarray(a), sr) for a, sr in alone], counted, eng.sample_rate,
                    eng.vocoder_config.hop_length)
    return out


def hang(rank: int) -> None:
    """Rank 0 waits in a barrier that rank 1 never reaches."""
    if rank == 0:
        dist.barrier()
    time.sleep(3600)


def fail(rank: int) -> None:
    """Rank 1 raises while rank 0 waits in a barrier."""
    if rank == 1:
        raise RuntimeError("rank 1 refuses")
    dist.barrier()

