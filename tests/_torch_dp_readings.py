"""Readings behind the dp-split frame bars of `tests/test_torch_sharding.py`,
over several seeds: the quantized tier's 4-slot batch against each slot run
as a batch of its own (the port, `dp_split_readings`) and JAX's first-frame
agreement under its own scheme (`tests/test_sharding.py:85-149`: the batch
dp-sharded on a (4, 2) mesh of 8 virtual CPU devices against the same batch
unsharded), with its keys drawn from the seed.

    python tests/_torch_dp_readings.py [first_seed] [last_seed]   # default 0 7

Prints one JSON line a seed. A plain script, not a test: it sets up JAX's 8
CPU devices itself before importing it."""

import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import test_torch_sharding as T  # noqa: E402
from qwen_tts_tpu.core.config import tiny_test_config  # noqa: E402
from qwen_tts_tpu.core.weights import init_tts_weights, quantize_decoder_weights  # noqa: E402
from qwen_tts_tpu.parallel.mesh import make_mesh  # noqa: E402
from qwen_tts_tpu.runtime.batch import batched_frames, batched_prefill  # noqa: E402


def jax_first_agree(seed: int) -> float:
    """JAX's `test_quantized_batched_frames_dp_sharded` measure, its four
    keys split from PRNGKey(seed)."""
    kw, kp, kt, kr = jax.random.split(jax.random.PRNGKey(seed), 4)
    mc = tiny_test_config(max_seq_len=64)
    w = init_tts_weights(kw, mc)
    qt = quantize_decoder_weights(w.talker)
    qcp = w.code_predictor._replace(
        decoder=quantize_decoder_weights(w.code_predictor.decoder, quant_head=False))
    B, h, N = 4, mc.talker.hidden_size, T.N_FRAMES
    prefill = jax.random.normal(kp, (B, 8, h), dtype=jnp.bfloat16)
    trailing = jax.random.normal(kt, (B, 4, h), dtype=jnp.bfloat16)
    tlen, tidx0 = jnp.full((B,), 4, jnp.int32), jnp.zeros((B,), jnp.int32)
    pad, rngs = jnp.zeros((h,), jnp.bfloat16), jax.random.split(kr, B)

    def run(qt_, qcp_, pre, tr):
        st, tok0, hid0 = batched_prefill(mc.talker, qt_, pre, kv_dtype=jnp.int8)
        _, codes, _, _, _ = batched_frames(mc.talker, mc.code_predictor, qt_, qcp_, st, tok0,
                                           hid0, tr, tlen, tidx0, pad, rngs, num_frames=N)
        return np.asarray(codes)

    codes_u = run(qt, qcp, prefill, trailing)
    mesh = make_mesh(dp=4, tp=2)
    repl, rows = NamedSharding(mesh, P()), NamedSharding(mesh, P("dp", None, None))
    codes_s = run(jax.device_put(qt, repl), jax.device_put(qcp, repl),
                  jax.device_put(prefill, rows), jax.device_put(trailing, rows))
    return float((codes_u[:, 0] == codes_s[:, 0]).mean())


def main(argv) -> None:
    torch.set_num_threads(4)
    first, last = (int(a) for a in argv) if argv else (0, 7)
    for seed in range(first, last + 1):
        r = T.dp_split_readings(*T._seeded_inputs(seed))
        gaps = [gap for *_x, gap in r["partings"]]
        print(json.dumps({
            "seed": seed, "jax_first_agree": jax_first_agree(seed),
            "port_first_agree": r["first_agree"], "port_slots_equal": r["slots_equal"],
            "forced_hidden_cos_min": r["hidden_cos_min"],
            "forced_partings": len(gaps), "forced_frames": 4 * T.N_FRAMES,
            "forced_max_parting_gap": max(gaps, default=None),
            "forced_agree_before_parting": r["agree_before_parting"]}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
